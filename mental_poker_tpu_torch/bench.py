"""The port's benchmark (counterpart of the repository's `bench.py`): it
prints one JSON line with the chosen mode's metric.

Run on a machine with a CUDA card:

    python -m mental_poker_tpu_torch.bench                          # shuffle52
    MPTPU_BENCH_MODE=multigame python -m mental_poker_tpu_torch.bench

Modes (`MPTPU_BENCH_MODE`), with `bench.py`'s shapes, seeds and draw order:

- `shuffle52` (default): B = 128 52-card decks at (m, n) = (2, 26) on the
  Stark curve, permuted and remasked on the card, each proved and verified
  by the staged flow (`device_api.prove_shuffle` / `verify_shuffle`).
- `msm`: one variable-base MSM of 1,024 Stark points (`ops/msm.py::msm`,
  the wide split into 128 statements of 8 points).
- `deck1024`: one 1,024-card deck at (16, 64), B = 1, proved and verified.
- `multigame`: G = 64 games of P = 8 players at (2, 26), independent keys:
  every deck masked with Chaum-Pedersen proofs, remasked with proofs, every
  player's reveal tokens with proofs, each proof batch verified on the card
  (`crypto/sigma_device.py`), and the cards unmasked and compared.

Each mode runs once to warm up, then `MPTPU_BENCH_REPS` (3) timed runs,
each ending in `torch.cuda.synchronize()`; every check is asserted on every
run. The JSON line holds `metric`, `value` (units over the mean run), `unit`,
`vs_baseline` (against `bench.py`'s analytic estimates of the Rust reference
on one CPU core: 5.0 shuffle pairs/s, 170,000 MSM points/s, 0.3 deck1024
pairs/s, 1.6 games/s), `runs_s` (every timed run), `stage_timing` (whether
the runs synchronized after every stage), `fuse_b_max` (batches up to this
size ran fused, as CUDA graphs; 0: none did) and `device` (the card's name
and power limit from nvidia-smi).

Knobs, as `bench.py` reads them (`config.py`):

- `MPTPU_BENCH_BATCH` (128): the decks of a shuffle52 batch; 1 is the
  single-proof latency mode.
- `MPTPU_FUSE_B=1` with `MPTPU_BENCH_BATCH=1`: the B=1 prove and verify
  each replay a CUDA graph of the staged flow, captured in the warm run
  (the fused latency mode, `arguments/fused.py`); unset, they run staged.
- `MPTPU_BENCH_SMOKE=1`: shuffle52 at (m, n) = (2, 4).
- `MPTPU_STAGE_TIMING=1`: shuffle52 prints to stderr the mean prove+verify
  and one line a stage (`arguments/staged.py::stage_report`, steady ms a
  call, calls, the first call's seconds), in `bench.py`'s format, over the
  warm and the timed runs. Each stage then ends in a synchronize, which
  the timed runs pay for: take a rate from a run with stage timing off and
  the stage report from a run of its own.
- `MPTPU_PROFILE=DIR`: after the timed runs of any mode (and the stage
  report), one more run is traced by `torch.profiler` (`profiling.trace`):
  a Chrome trace in DIR, and on stderr the run's device-busy ms, the idle
  share of the mean timed run (1 - busy / mean run) and of the traced run
  (which the profiler slows), and the top device operations; with
  `MPTPU_STAGE_TIMING=1` too, each stage's device ms. The traced run enters
  neither the timed runs nor the stage report.

Fixed-base tables take 8-bit windows unless `MPTPU_FIXED_WINDOW` says
otherwise (as `bench.py` sets it). Each mode is a function of `device`
(default "cuda") and its sizes, so that a test can run it small on the CPU;
the command line runs on the card only.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from . import config, profiling
from .arguments import device_api, staged
from .crypto import elgamal, sigma_device as sdev, transcript_dev as dt
from .crypto.elgamal import Ciphertexts
from .crypto.transcript import MASKING_RNG_SEED, REMASKING_RNG_SEED, REVEAL_RNG_SEED
from .ops import msm as msm_mod
from .ops.curve import PointP, map_point, stark_curve
from .protocol.dl_cards import DLCards
from .utils.rand import GameRng, ints_to_limbs, limbs_to_int

# The Rust reference on one CPU core, `bench.py`'s analytic estimates.
ARKWORKS_CPU_SHUFFLE52_PAIRS_PER_S = 5.0
ARKWORKS_CPU_MSM_POINTS_PER_S = 170_000.0
ARKWORKS_CPU_DECK1024_PAIRS_PER_S = 0.3
ARKWORKS_CPU_MULTIGAME_GAMES_PER_S = 1.6

BENCH_FIXED_WINDOW = "8"  # bench.py:38
REPS = config.RuntimeConfig.bench_reps  # timed runs after the warm one
BATCH = config.RuntimeConfig.bench_batch  # decks of a shuffle52 batch
SMOKE_SHAPE = (2, 4)  # (m, n) of shuffle52 under MPTPU_BENCH_SMOKE, bench.py:61


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def device_name(device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def timed_runs(one, reps: int, device, report=None) -> list:
    """One warm run of `one()`, then `reps` timed runs; seconds of each.
    `report(runs)` is called after them. With `profile_dir` set, one more
    run after that is traced (`profiling.trace`) and its summary printed to
    stderr."""
    one()
    _sync(device)
    runs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        one()
        _sync(device)
        runs.append(time.perf_counter() - t0)
    if report is not None:
        report(runs)
    prof_dir = config.get_config().profile_dir
    if prof_dir:
        print_trace(profiling.trace(one, prof_dir, "bench_trace", device), runs)
    return runs


def print_trace(tr: dict, runs: list) -> None:
    """A traced run's summary on stderr: the trace file, and on a card the
    device-busy ms, the idle share of the mean of the timed `runs` and of
    the traced run, the port's kernels' device ms, each stage's device ms
    (with `stage_timing` on) and the top device operations."""
    print(f"# trace: {tr['trace']} ({tr['wall_s'] * 1e3:.1f} ms run)", file=sys.stderr)
    if "device_busy_ms" not in tr:
        return
    mean_s = sum(runs) / len(runs)
    print(f"# device busy {tr['device_busy_ms']:.3f} ms in {tr['device_launches']} launches; "
          f"idle share {1 - tr['device_busy_ms'] / 1e3 / mean_s:.4f} of the {mean_s * 1e3:.1f} ms mean timed run, "
          f"{tr['idle_share_of_traced']:.4f} of the traced run", file=sys.stderr)
    print(f"# kernel device ms {json.dumps(tr['kernel_device_ms'])}", file=sys.stderr)
    if tr["stage_device_ms"]:
        print(f"# stage device ms [ms, calls] {json.dumps(tr['stage_device_ms'])}", file=sys.stderr)
    for name, ms, count in tr["top_ops"]:
        print(f"# device op {ms:10.3f} ms  x{count:<6} {name}", file=sys.stderr)


def result(metric: str, units: float, runs: list, unit: str, baseline: float, digits: int, device) -> dict:
    """`bench.py`'s JSON fields for `units` of work per run, and the runs."""
    rate = units / (sum(runs) / len(runs))
    return {
        "metric": metric,
        "value": round(rate, digits),
        "unit": unit,
        "vs_baseline": round(rate / baseline, 4),
        "runs_s": runs,
        "stage_timing": config.get_config().stage_timing,
        "fuse_b_max": config.get_config().fuse_b_max,
        "device": device_name(device),
    }


# ---------------------------------------------------------------------------
# shuffle52 and deck1024: the staged prove+verify of B decks
# ---------------------------------------------------------------------------


class ShuffleBench(NamedTuple):
    cv: object
    m: int
    n: int
    keys: object
    deck: Ciphertexts
    shuffled: Ciphertexts
    pi: torch.Tensor
    rho: torch.Tensor
    rng: GameRng

    def prove_verify(self):
        """One prove+verify of the batch with fresh prover randomness ->
        (proof, checks)."""
        cv, m, n = self.cv, self.m, self.n
        rand = device_api.sample_shuffle_rand(
            self.rng, m, n, cv.fr.L, cv.host.order, batch=self.pi.shape[0], device=self.pi.device
        )
        proof = device_api.prove_shuffle(cv, m, n, self.keys, self.deck, self.shuffled, self.pi, self.rho, rand)
        return proof, device_api.verify_shuffle(cv, m, n, self.keys, self.deck, self.shuffled, proof)

    def one(self) -> None:
        _, checks = self.prove_verify()
        if not all(bool(c.all()) for c in checks):
            raise RuntimeError("bench proof failed to verify")


def shuffle_setup(m: int, n: int, batch: int, seed: int, info: bytes, device="cuda") -> ShuffleBench:
    """`bench.py`'s statement: `DLCards` parameters and one player's key from
    `GameRng(seed)`, B random decks, permutations and remask factors, the
    permute+remask on `device`."""
    N = m * n
    proto = DLCards(device=device)
    rng = GameRng(seed)
    pp = proto.setup(rng, m, n)
    pk, sk = proto.player_keygen(rng, pp)
    kproof = proto.prove_key_ownership(rng, pp, pk, sk, info)
    agg = proto.compute_aggregate_key(pp, [(pk, kproof, info)])
    cv = proto.cv
    q = cv.host.order
    flat = elgamal.rand_ciphertexts(cv, rng, batch * N, device)
    deck = Ciphertexts(*(map_point(lambda t: t.reshape(batch, N, -1), c) for c in flat))
    pi = torch.as_tensor(np.stack([rng.permutation(N) for _ in range(batch)]).astype(np.int64), device=device)
    rho = torch.as_tensor(
        ints_to_limbs([[rng.scalar(q) for _ in range(N)] for _ in range(batch)], cv.fr.L).astype(np.int32),
        device=device,
    )
    permuted = Ciphertexts(*(map_point(lambda t: torch.gather(t, 1, pi[..., None].expand(t.shape)), c) for c in deck))
    shuffled = elgamal.cipher_add(cv, permuted, elgamal.encrypt_zero(pp.enc, agg.table, rho))
    _sync(device)
    return ShuffleBench(cv, m, n, device_api.make_keys(pp, agg), deck, shuffled, pi, rho, rng)


def bench_shuffle52(reps: int = REPS, batch: int = BATCH, m: int = 2, n: int = 26, device="cuda") -> dict:
    """`bench.py::bench_shuffle52`: prove+verify pairs per second."""
    return shuffle52_result(shuffle_setup(m, n, batch, 1234, b"bench", device), reps, device)


def shuffle52_result(sb: ShuffleBench, reps: int, device) -> dict:
    """The timed runs of shuffle52 on a set-up batch, as `bench_shuffle52`
    reports them. With `stage_timing` on, the mean run and the stage report
    go to stderr before any traced run."""
    batch = sb.pi.shape[0]

    def report(runs):
        print_stage_report(sum(runs) / len(runs), batch)

    runs = timed_runs(sb.one, reps, device, report if config.get_config().stage_timing else None)
    return result("torch_shuffle52_prove_verify_pairs_per_s", batch, runs, "proofs/s/chip",
                  ARKWORKS_CPU_SHUFFLE52_PAIRS_PER_S, 4, device)


def print_stage_report(run_s: float, batch: int) -> None:
    """`bench.py:118-126`'s report: the mean prove+verify, then each stage's
    steady ms a call, its calls and its first call's seconds."""
    print(f"# prove+verify: {run_s * 1e3:.1f} ms per {batch}-deck batch", file=sys.stderr)
    for key, steady_ms, calls, first in staged.stage_report():
        print(f"# stage {key[0]:<10} {str(key[4:]):<12} {steady_ms:9.2f} ms/call  x{calls}  (first {first:.2f} s)",
              file=sys.stderr)


def bench_deck1024(reps: int = REPS, m: int = 16, n: int = 64, device="cuda") -> dict:
    """`bench.py::bench_deck1024`: one (16, 64) deck, B = 1."""
    sb = shuffle_setup(m, n, 1, 99, b"b", device)
    runs = timed_runs(sb.one, reps, device)
    return result("torch_deck1024_prove_verify_pairs_per_s", 1, runs, "proofs/s/chip",
                  ARKWORKS_CPU_DECK1024_PAIRS_PER_S, 4, device)


# ---------------------------------------------------------------------------
# msm: one variable-base MSM
# ---------------------------------------------------------------------------


def msm_setup(npts: int = 1024, device="cuda"):
    """`bench.py::bench_msm`'s inputs: (curve, points [npts], scalars)."""
    cv = stark_curve()
    rng = GameRng(7)
    pts = elgamal.rand_plaintexts(cv, rng, npts, device)
    k = ints_to_limbs([rng.scalar(cv.host.order) for _ in range(npts)], cv.fr.L)
    return cv, pts, torch.as_tensor(k.astype(np.int32), device=device)


def bench_msm(reps: int = REPS, npts: int = 1024, device="cuda") -> dict:
    """`bench.py::bench_msm`: points per second of one MSM."""
    cv, pts, k = msm_setup(npts, device)
    runs = timed_runs(lambda: msm_mod.msm(cv, pts, k), reps, device)
    return result(f"torch_msm_{npts}_points_per_s", npts, runs, "points/s/chip",
                  ARKWORKS_CPU_MSM_POINTS_PER_S, 1, device)


# ---------------------------------------------------------------------------
# multigame: G games of P players, mask / remask / reveal with CP proofs
# ---------------------------------------------------------------------------


class Multigame(NamedTuple):
    cv: object
    G: int
    P: int
    N: int
    sks: torch.Tensor  # [G, P, L] canonical secret keys
    gens: PointP  # [G] generators
    pks: PointP  # [G, P] player keys
    g_b: PointP  # [G * N] each game's generator, once per card
    pk_b: PointP  # [G * N] each game's aggregate key, once per card
    cards: PointP  # [G * N]
    rng: GameRng


class FlowResult(NamedTuple):
    checks: tuple  # bool [G N], [G N], [G P N], [G N]: mask, remask, reveal, unmask
    proofs: tuple  # the CPProofDev of the mask, remask and reveal stages
    reveal: tuple  # the reveal statement [G P N]: bases (d0, g), points (token, pk)


def _repeat(P: PointP, reps: int) -> PointP:
    """[G, L] -> [G * reps, L], each game's point `reps` times."""
    return map_point(lambda t: t.repeat_interleave(reps, dim=0), P)


def multigame_setup(G: int = 64, P: int = 8, m: int = 2, n: int = 26, device="cuda") -> Multigame:
    """`bench.py::bench_multigame`'s set-up from `GameRng(11)`: G random
    generators, the (G, P) secret keys, the player keys, each game's
    aggregate key (sum of its players' keys times its generator) and G * N
    cards. Every per-card point is a flat [G * N] batch: `sigma_device`
    reads a three-dimensional point as a window table."""
    N = m * n
    cv = stark_curve()
    fr = cv.fr
    q = cv.host.order
    rng = GameRng(11)
    gens = cv.from_host_points([cv.host.rand_point(rng.rng) for _ in range(G)], device)
    sks_np = rng.scalar_limbs(q, (G, P), fr.L)
    sks = torch.as_tensor(sks_np.astype(np.int32), device=device)
    gens_p = map_point(lambda t: t[:, None].expand(G, P, t.shape[-1]), gens)
    pks = cv.scalar_mul(sks, gens_p)
    agg_sk = [sum(limbs_to_int(sks_np[g, p]) for p in range(P)) % q for g in range(G)]
    agg_pk = cv.scalar_mul(torch.as_tensor(ints_to_limbs(agg_sk, fr.L).astype(np.int32), device=device), gens)
    cards = elgamal.rand_plaintexts(cv, rng, G * N, device)
    return Multigame(cv, G, P, N, sks, gens, pks, _repeat(gens, N), _repeat(agg_pk, N), cards, rng)


def multigame_flow(mg: Multigame) -> FlowResult:
    """One round of every game (`bench.py:263-361`), drawing alphas, ks,
    betas, ks2 and ks3 from the set-up's `GameRng` in that order."""
    cv, G, P, N, rng = mg.cv, mg.G, mg.P, mg.N, mg.rng
    L = cv.fr.L
    q = cv.host.order
    dev = mg.sks.device
    GN, M = G * N, G * P * N

    def draw(count):
        return torch.as_tensor(rng.scalar_limbs(q, (count,), L).astype(np.int32), device=dev)

    # mask every deck, prove and verify
    alphas = draw(GN)
    c0 = cv.scalar_mul(alphas, mg.g_b)
    c1 = cv.add(mg.cards, cv.scalar_mul(alphas, mg.pk_b))
    stmt_b = cv.add(c1, cv.neg(mg.cards))
    ks = draw(GN)
    prf = sdev.cp_prove_dev(cv, dt.init(MASKING_RNG_SEED, (GN,), dev), mg.g_b, mg.pk_b, c0, stmt_b, alphas, ks)
    ok_mask = sdev.cp_verify_dev(cv, dt.init(MASKING_RNG_SEED, (GN,), dev), mg.g_b, mg.pk_b, c0, stmt_b, prf)

    # remask, prove and verify
    betas = draw(GN)
    r0 = cv.scalar_mul(betas, mg.g_b)
    r1 = cv.scalar_mul(betas, mg.pk_b)
    d0, d1 = cv.add(c0, r0), cv.add(c1, r1)
    ks2 = draw(GN)
    prf2 = sdev.cp_prove_dev(cv, dt.init(REMASKING_RNG_SEED, (GN,), dev), mg.g_b, mg.pk_b, r0, r1, betas, ks2)
    ok_remask = sdev.cp_verify_dev(cv, dt.init(REMASKING_RNG_SEED, (GN,), dev), mg.g_b, mg.pk_b, r0, r1, prf2)

    # every player's reveal tokens, prove and verify: statements [G, P, N] flat
    d0_b = map_point(lambda t: t.reshape(G, 1, N, -1).expand(G, P, N, t.shape[-1]).reshape(M, -1), d0)
    sk_b = mg.sks[:, :, None, :].expand(G, P, N, L).reshape(M, L)
    tokens = cv.scalar_mul(sk_b, d0_b)
    g_bb = _repeat(mg.gens, P * N)
    pk_pl = map_point(lambda t: t.repeat_interleave(N, dim=1).reshape(M, -1), mg.pks)
    ks3 = draw(M)
    prf3 = sdev.cp_prove_dev(cv, dt.init(REVEAL_RNG_SEED, (M,), dev), d0_b, g_bb, tokens, pk_pl, sk_b, ks3)
    ok_reveal = sdev.cp_verify_dev(cv, dt.init(REVEAL_RNG_SEED, (M,), dev), d0_b, g_bb, tokens, pk_pl, prf3)

    # unmask: d1 - sum_p token_p gives back the cards
    tok_sum = cv.sum_points(map_point(lambda t: t.reshape(G, P, N, -1), tokens), axis=1)
    plain = cv.add(cv.neg(map_point(lambda t: t.reshape(GN, -1), tok_sum)), d1)
    ok_plain = cv.eq(plain, mg.cards)
    return FlowResult((ok_mask, ok_remask, ok_reveal, ok_plain), (prf, prf2, prf3), (d0_b, g_bb, tokens, pk_pl))


def bench_multigame(reps: int = REPS, G: int = 64, P: int = 8, m: int = 2, n: int = 26, device="cuda") -> dict:
    """`bench.py::bench_multigame`: games per second."""
    mg = multigame_setup(G, P, m, n, device)

    def one():
        if not all(bool(ok.all()) for ok in multigame_flow(mg).checks):
            raise RuntimeError("multigame flow check failed")

    runs = timed_runs(one, reps, device)
    return result("torch_multigame_8p_games_per_s", G, runs, "games/s/chip",
                  ARKWORKS_CPU_MULTIGAME_GAMES_PER_S, 3, device)


def run(mode: str, reps: int = REPS, batch: int = BATCH, smoke: bool = False, device="cuda") -> dict:
    """The mode's result at its full size (shuffle52 at `batch` decks, at
    (2, 4) when `smoke`), as `main` prints it."""
    if mode == "msm":
        return bench_msm(reps, device=device)
    if mode == "deck1024":
        return bench_deck1024(reps, device=device)
    if mode == "multigame":
        return bench_multigame(reps, device=device)
    if mode != "shuffle52":
        raise ValueError(f"unknown MPTPU_BENCH_MODE {mode!r}: shuffle52, msm, deck1024 or multigame")
    m, n = SMOKE_SHAPE if smoke else (2, 26)
    return bench_shuffle52(reps, batch, m, n, device=device)


def main() -> int:
    if not torch.cuda.is_available():
        print("bench: no CUDA device (the bench runs on the card only)", file=sys.stderr)
        return 2
    os.environ.setdefault("MPTPU_FIXED_WINDOW", BENCH_FIXED_WINDOW)
    config.set_config(None)  # read the environment with the bench's default window
    cfg = config.get_config()
    print(json.dumps(run(cfg.bench_mode, cfg.bench_reps, cfg.bench_batch, cfg.bench_smoke)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
