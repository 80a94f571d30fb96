"""Parameter-selection benchmark: the reference's
`examples/parameter_selection.rs` flow (counterpart of
`mental_poker_tpu/models/parameter_selection.py`).

The Bayer-Groth cost model (`parameter_selection.rs:1-10`): the prover
computes m*N curve exponentiations for a deck of N = m*n cards, and the proof
serializes to about 6m*|G| + 4n*|Z| bytes, smallest near m = n/3. This module
sweeps (m, n) splits and measures prover and verifier wall time and the
serialized proof size; the reference sweeps `REFERENCE_SWEEP` for N = 300 on
BLS12-377 G1 (`parameter_selection.rs:41-42`).

Each point draws its keys, deck, permutation and masking factors from
`GameRng(seed)` in the JAX package's order, so one seed gives both packages
the same statement. Tensors live on `device`; on the card each timing ends
in `torch.cuda.synchronize()`.

    python -m mental_poker_tpu_torch.models.parameter_selection        # the sweep
    python -m mental_poker_tpu_torch.models.parameter_selection m n    # one point, Stark curve
"""

from __future__ import annotations

import time

import torch

from ..crypto import elgamal, proof_io
from ..ops import curve as curve_mod
from ..protocol.dl_cards import DLCards
from ..utils.rand import GameRng

REFERENCE_SWEEP = [(2, 150), (6, 50), (10, 30), (12, 25), (30, 10)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def benchmark_parameters(m: int, n: int, curve=None, seed: int = 0, verbose: bool = True, device="cuda") -> dict:
    """One (m, n) point: the key ceremony of one player, then one shuffle
    proved and verified (`parameter_selection.rs:31-99`). Raises if the
    verifier rejects the proof."""
    proto = DLCards(curve, device=device)
    dev = proto.device
    rng = GameRng(seed)
    num_cards = m * n
    pp = proto.setup(rng, m, n)

    pk, sk = proto.player_keygen(rng, pp)
    info = b"Player 0"
    key_proof = proto.prove_key_ownership(rng, pp, pk, sk, info)
    joint_pk = proto.compute_aggregate_key(pp, [(pk, key_proof, info)])

    deck = elgamal.rand_ciphertexts(proto.cv, rng, num_cards, dev)
    pi = rng.permutation(num_cards)
    rho = [rng.scalar(proto.cv.host.order) for _ in range(num_cards)]

    _sync(dev)
    t0 = time.perf_counter()
    shuffled, proof = proto.shuffle_and_remask(rng, pp, joint_pk, deck, rho, pi)
    _sync(dev)
    prove_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    proto.verify_shuffle(pp, joint_pk, deck, shuffled, proof)
    _sync(dev)
    verify_s = time.perf_counter() - t0

    size = proof_io.shuffle_proof_size(proof, proto.cv.host)
    out = {
        "m": m,
        "n": n,
        "cards": num_cards,
        "prove_s": prove_s,
        "verify_s": verify_s,
        "proof_bytes": size,
    }
    if verbose:
        print(
            f"m={m:3d} n={n:4d} N={num_cards:5d}: prove {prove_s:8.3f}s  "
            f"verify {verify_s:8.3f}s  proof {size:7d} B",
            flush=True,
        )
    return out


def run_sweep(sweep=None, curve=None, seed: int = 0, verbose: bool = True, device="cuda") -> list[dict]:
    """The reference sweep (N = 300 on BLS12-377 G1 by default)."""
    cv = curve or curve_mod.bls12_377_g1()
    return [benchmark_parameters(m, n, cv, seed, verbose, device) for (m, n) in (sweep or REFERENCE_SWEEP)]


if __name__ == "__main__":
    import sys

    if len(sys.argv) == 3:
        benchmark_parameters(int(sys.argv[1]), int(sys.argv[2]))
    else:
        run_sweep()
