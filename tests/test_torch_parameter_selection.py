"""The port's parameter-selection benchmark (`models/parameter_selection.py`,
the reference's `examples/parameter_selection.rs` flow) on the CPU, against
the JAX package's `tests/test_parameter_selection.py` points.

One scaled-down sweep on the Stark curve, `seed=3`, a point a case (each
point draws from its own `GameRng(seed)`, so a sweep of one point gives
that point's row): its (2, 4) point is `benchmark_parameters(2, 4, stark,
seed=3)`, the JAX test's point, and each point must give the JAX package's
card count, proof size and proof bytes (their SHA-256, so the port draws
keys, deck, permutation and masking factors in the JAX order; pinned below,
the `slow` test recomputes them), and be verified; the (4, 2) point keeps
the JAX test's size ordering (more rows m, a larger proof). Tolerance:
exact.
"""

import hashlib

import pytest

from mental_poker_tpu_torch.models import parameter_selection as ps
from mental_poker_tpu_torch.ops import curve as curve_mod

from _torch_bridge import one_torch_thread  # noqa: F401

SWEEP = [(2, 4), (4, 2)]

# JAX `run_sweep(sweep=SWEEP, curve=stark_curve(), seed=3)`: (cards, proof
# bytes), and the SHA-256 of each point's serialized proof (`shuffle_to_bytes`).
JAX_PIN = [(8, 1912), (8, 2296)]
JAX_PROOF_SHA256 = [
    "c3ee521b1935477c67db8cd2a3943ac71ea72a873c9c0b56a193dc41429d8953",
    "5aec37e97c8500ae1d12da3f5de1768909c65bd305a90663a68fcd2e2cc6fbe8",
]


def record_proofs(monkeypatch, proof_io) -> list:
    """SHA-256 of every proof that `benchmark_parameters` sizes, in order."""
    digests = []
    size = proof_io.shuffle_proof_size

    def recording(proof, curve):
        digests.append(hashlib.sha256(proof_io.shuffle_to_bytes(proof, curve)).hexdigest())
        return size(proof, curve)

    monkeypatch.setattr(proof_io, "shuffle_proof_size", recording)
    return digests


def test_reference_sweep_is_the_rust_one():
    assert ps.REFERENCE_SWEEP == [(2, 150), (6, 50), (10, 30), (12, 25), (30, 10)]
    assert all(m * n == 300 for m, n in ps.REFERENCE_SWEEP)


@pytest.mark.parametrize("i", range(len(SWEEP)), ids=[f"{m}x{n}" for m, n in SWEEP])
def test_scaled_down_sweep_matches_jax(monkeypatch, i):
    """`benchmark_parameters` raises unless the verifier accepts the proof."""
    digests = record_proofs(monkeypatch, ps.proof_io)
    rows = ps.run_sweep(sweep=[SWEEP[i]], curve=curve_mod.stark_curve(), seed=3, verbose=False, device="cpu")
    assert [(r["m"], r["n"]) for r in rows] == [SWEEP[i]]
    assert [(r["cards"], r["proof_bytes"]) for r in rows] == [JAX_PIN[i]]
    assert digests == [JAX_PROOF_SHA256[i]]
    assert all(r["prove_s"] > 0 and r["verify_s"] > 0 for r in rows)
    assert JAX_PIN[1][1] > JAX_PIN[0][1]  # ~6m|G| + 4n|Z|: more rows, a larger proof


@pytest.mark.slow
def test_pins_recomputed_through_jax(monkeypatch):
    from mental_poker_tpu.models import parameter_selection as jps
    from mental_poker_tpu.ops import curve as jcurve

    digests = record_proofs(monkeypatch, jps.proof_io)
    rows = jps.run_sweep(sweep=SWEEP, curve=jcurve.stark_curve(), seed=3)
    assert [(r["cards"], r["proof_bytes"]) for r in rows] == JAX_PIN
    assert digests == JAX_PROOF_SHA256
