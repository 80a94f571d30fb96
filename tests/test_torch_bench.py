"""The port's bench (`mental_poker_tpu_torch/bench.py`) on the CPU, at small
sizes.

- `multigame` at G = 2 games, P = 2 players, (m, n) = (1, 2), `GameRng(11)`:
  the flow's four checks (mask, remask, reveal proofs verified; cards
  unmasked) hold in every lane, and the SHA-256 of each stage's proof
  tensors equals a pinned value. The `slow` test computes the pins through
  the JAX package, following `bench.py::bench_multigame`'s flow at the
  same sizes and seed.
- `msm` at 8 points: one JSON-serialisable result with `bench.py`'s keys,
  the runs and the device.
- The command line refuses to run without a card and prints nothing; with
  one it passes `MPTPU_BENCH_REPS`, `_BATCH` and `_SMOKE` from the config to
  the mode (`run` replaced); the smoke shape is (2, 4); `run` passes the
  repetitions to every mode and refuses an unknown one.
- `MPTPU_PROFILE`: one more run after the timed ones writes a Chrome trace
  (here with the CPU's activity only), and on a card its summary adds the
  device lines, the idle share against the mean timed run and the traced
  one; `MPTPU_STAGE_TIMING`'s report lines are `bench.py`'s, printed before
  the traced run, which the report does not count; the JSON line says
  whether stage timing was on.

Tolerance: exact equality of the hashed limbs.
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from mental_poker_tpu_torch import bench, config
from mental_poker_tpu_torch.arguments import staged

from _torch_bridge import one_torch_thread, to_np  # noqa: F401

G, P, M_, N_ = 2, 2, 1, 2

# SHA-256 of the mask, remask and reveal proofs' tensors at G = 2, P = 2,
# (1, 2): t_g (x, y, inf), t_h (x, y, inf), s, limbs as little-endian
# uint32 and flags as bytes.
PROOF_SHA256 = [
    "2ac513c42e4672114e7a61121cb120859fd085190590bdf622057e728714d75d",
    "0a9dd48d339b7a2bf32452ba0516091df5b84f433e731d2b329e6033ba02995e",
    "17fbd76cca9998b3056f4fb1732ab1ac5bf34a36850faf02e7a4ed086fded8f4",
]


def proof_sha256(proof) -> str:
    h = hashlib.sha256()
    for t in (*proof.t_g, *proof.t_h, proof.s):
        a = to_np(t) if isinstance(t, torch.Tensor) else np.asarray(t)
        h.update(np.ascontiguousarray(a.astype(bool) if a.dtype == bool else a.astype("<u4")).tobytes())
    return h.hexdigest()


def test_multigame_flow_small():
    mg = bench.multigame_setup(G, P, M_, N_, device="cpu")
    out = bench.multigame_flow(mg)
    assert [c.shape[0] for c in out.checks] == [G * M_ * N_, G * M_ * N_, G * P * M_ * N_, G * M_ * N_]
    assert all(bool(c.all()) for c in out.checks)
    assert [proof_sha256(p) for p in out.proofs] == PROOF_SHA256


def test_msm_mode_result():
    res = json.loads(json.dumps(bench.bench_msm(reps=1, npts=8, device="cpu")))
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "runs_s", "stage_timing", "fuse_b_max", "device"}
    assert res["metric"] == "torch_msm_8_points_per_s" and res["unit"] == "points/s/chip"
    assert len(res["runs_s"]) == 1 and res["value"] > 0 and res["device"] == "cpu"
    assert res["vs_baseline"] == round(res["value"] / bench.ARKWORKS_CPU_MSM_POINTS_PER_S, 4)
    with pytest.raises(ValueError):
        bench.run("nonesuch", device="cpu")


def test_no_card_no_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize(
    "env,want",
    [({}, ("shuffle52", 3, 128, False)),
     ({"MPTPU_BENCH_REPS": "5", "MPTPU_BENCH_BATCH": "1", "MPTPU_BENCH_SMOKE": "1"}, ("shuffle52", 5, 1, True))],
    ids=["defaults", "knobs"],
)
def test_main_passes_config_knobs(monkeypatch, capsys, env, want):
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(bench, "run", lambda *args: seen.append(args) or {"metric": "stub"})
    for k in ("MPTPU_FIXED_WINDOW", "MPTPU_BENCH_MODE", "MPTPU_BENCH_REPS", "MPTPU_BENCH_BATCH", "MPTPU_BENCH_SMOKE"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    try:
        assert bench.main() == 0
        assert seen == [want]
        assert config.get_config().fixed_window_bits == 8  # the bench's window
        assert json.loads(capsys.readouterr().out) == {"metric": "stub"}
    finally:
        # bench.main sets the bench's window in os.environ, past monkeypatch:
        # left there, every later test of the worker would build 8-bit tables.
        os.environ.pop("MPTPU_FIXED_WINDOW", None)
        config.set_config(None)


def test_smoke_shape(monkeypatch):
    seen = []
    monkeypatch.setattr(bench, "bench_shuffle52", lambda *args, device: seen.append(args + (device,)))
    bench.run("shuffle52", 2, 4, smoke=True, device="cpu")
    bench.run("shuffle52", 2, 4, device="cpu")
    assert seen == [(2, 4, 2, 4, "cpu"), (2, 4, 2, 26, "cpu")]
    assert bench.SMOKE_SHAPE == (2, 4)


@pytest.mark.parametrize("mode", ["msm", "deck1024", "multigame", "shuffle52"])
def test_run_passes_reps_to_the_mode(monkeypatch, mode):
    seen = []
    for name in ("msm", "deck1024", "multigame", "shuffle52"):
        monkeypatch.setattr(bench, f"bench_{name}", lambda *args, _n=name, **kw: seen.append((_n, args, kw)))
    bench.run(mode, 7, device="cpu")
    want_args = (7, 128, 2, 26) if mode == "shuffle52" else (7,)
    assert seen == [(mode, want_args, {"device": "cpu"})]
    with pytest.raises(ValueError, match="unknown MPTPU_BENCH_MODE"):
        bench.run(mode.upper(), 7, device="cpu")


@pytest.mark.parametrize("runs,idle", [([0.25], "0.5000 of the 250.0 ms"), ([0.4, 0.5, 0.6], "0.7500 of the 500.0 ms")],
                         ids=["one_run", "three_runs"])
def test_print_trace_card_summary(capsys, runs, idle):
    """On a card the summary adds the busy ms, the idle share of the mean
    timed run and of the (slower) traced run, kernel and stage device ms and
    one line a top operation."""
    tr = dict(trace="/x/bench_trace.json", wall_s=1.0, device_busy_ms=125.0, idle_share_of_traced=0.875,
              device_launches=40, kernel_device_ms={"mont_mul": 1.5, "all": 125.0}, stage_device_ms={"stmt": [2.0, 1]},
              top_ops=[("mont_mul_kernel<8>", 1.5, 30)])
    bench.print_trace(tr, runs)
    assert capsys.readouterr().err.splitlines() == [
        "# trace: /x/bench_trace.json (1000.0 ms run)",
        f"# device busy 125.000 ms in 40 launches; idle share {idle} mean timed run, 0.8750 of the traced run",
        '# kernel device ms {"mont_mul": 1.5, "all": 125.0}',
        '# stage device ms [ms, calls] {"stmt": [2.0, 1]}',
        "# device op      1.500 ms  x30     mont_mul_kernel<8>",
    ]


def test_profile_run_writes_a_trace(tmp_path, capsys):
    calls = []
    with config.override(profile_dir=str(tmp_path)):
        runs = bench.timed_runs(lambda: calls.append(float(torch.ones(4).sum())), 2, "cpu")
    assert len(runs) == 2 and len(calls) == 4  # warm, two timed, traced
    path = tmp_path / "bench_trace.json"
    assert json.loads(path.read_text())["traceEvents"]
    err = capsys.readouterr().err
    assert f"# trace: {path}" in err
    assert "device busy" not in err  # the CPU has no device activity to report

    from torch.profiler import ProfilerActivity, profile

    from mental_poker_tpu_torch import profiling

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert profiling.device_spans(prof) == []  # the kineto results read, no device event among them


def test_timed_runs_without_trace(capsys):
    calls = []
    with config.override(profile_dir=None):
        runs = bench.timed_runs(lambda: calls.append(1), 3, "cpu")
    assert len(runs) == 3 and len(calls) == 4 and all(r >= 0 for r in runs)  # warm + three timed
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("timing", [False, True], ids=["timing_off", "timing_on"])
def test_shuffle52_result_reports_stages_with_timing(monkeypatch, capsys, timing):
    """`shuffle52_result` prints the stage report after the timed runs only
    with `stage_timing` on; the rate is the batch over the mean run."""
    def timed_runs(one, reps, device, report=None):
        if report is not None:
            report([0.5] * reps)
        return [0.5] * reps

    monkeypatch.setattr(bench, "timed_runs", timed_runs)
    sb = bench.ShuffleBench(None, 2, 4, None, None, None, torch.zeros((4, 8), dtype=torch.int32), None, None)
    saved = dict(staged.STAGE_TIMES)
    staged.STAGE_TIMES.clear()
    staged.STAGE_TIMES[("stmt", "stark", 2, 4)] = [0.3, 2, 0.2]
    try:
        with config.override(stage_timing=timing):
            res = bench.shuffle52_result(sb, 2, "cpu")
    finally:
        staged.STAGE_TIMES.clear()
        staged.STAGE_TIMES.update(saved)
    assert res["value"] == pytest.approx(8.0) and res["runs_s"] == [0.5, 0.5] and res["stage_timing"] is timing
    err = capsys.readouterr().err.splitlines()
    assert err == (["# prove+verify: 500.0 ms per 4-deck batch",
                    "# stage stmt       ()              100.00 ms/call  x2  (first 0.20 s)"] if timing else [])


def test_stage_report_lines(capsys):
    """`bench.py:118-126`'s lines (its format strings, copied below)."""
    times = {("commit", "stark", 26, 2): [0.5, 9, 0.1], ("combo", "stark", 2, 26, 4, 52): [0.2, 2, 0.15]}
    saved = dict(staged.STAGE_TIMES)
    staged.STAGE_TIMES.clear()
    staged.STAGE_TIMES.update(times)
    try:
        bench.print_stage_report(0.25, 128)
        rows = staged.stage_report()
    finally:
        staged.STAGE_TIMES.clear()
        staged.STAGE_TIMES.update(saved)
    dt, batch = 0.25, 128
    want = [f"# prove+verify: {dt*1e3:.1f} ms per {batch}-deck batch"] + [
        f"# stage {key[0]:<10} {str(key[4:]):<12} {steady_ms:9.2f} ms/call  x{calls}  (first {first:.2f} s)"
        for key, steady_ms, calls, first in rows
    ]
    assert capsys.readouterr().err.splitlines() == want
    assert [r[0][0] for r in rows] == ["commit", "combo"] and want[1].endswith("50.00 ms/call  x9  (first 0.10 s)")


@pytest.mark.parametrize("reps,traced", [(1, True), (2, True), (2, False)], ids=["trace-1", "trace-2", "no_trace-2"])
def test_report_precedes_the_traced_run(tmp_path, capsys, reps, traced):
    """`timed_runs` hands the timed runs to `report` before the traced run,
    so that run enters neither the runs nor the stage report: a stage timed
    in every call of `one` shows the warm and the timed calls alone."""
    key = ("stmt", "stark", 2, 4)

    class Batch:
        pi = torch.zeros((3, 8), dtype=torch.int64)

        def one(self):
            staged._timed(key, lambda _: None, None, ())

    saved = dict(staged.STAGE_TIMES)
    staged.STAGE_TIMES.clear()
    try:
        with config.override(stage_timing=True, profile_dir=str(tmp_path) if traced else None):
            res = bench.shuffle52_result(Batch(), reps, "cpu")
        calls = staged.STAGE_TIMES[key][1]
    finally:
        staged.STAGE_TIMES.clear()
        staged.STAGE_TIMES.update(saved)
    err = capsys.readouterr().err.splitlines()
    assert len(res["runs_s"]) == reps and calls == 1 + reps + traced
    assert err[0].startswith("# prove+verify: ") and err[0].endswith(" ms per 3-deck batch")
    assert err[1].startswith("# stage stmt ") and err[1].split("ms/call")[1].startswith(f"  x{1 + reps}  ")
    assert err[2:] == ([f"# trace: {tmp_path / 'bench_trace.json'} ({err[2].split('(')[1]}"] if traced else [])


@pytest.mark.parametrize("timing", [False, True], ids=["timing_off", "timing_on"])
def test_result_records_stage_timing(timing):
    """The JSON line says whether its runs synchronized after every stage,
    and up to which batch they ran fused (`fuse_b_max`), beside `bench.py`'s
    fields."""
    fuse_b_max = 1 if timing else 0
    with config.override(stage_timing=timing, fuse_b_max=fuse_b_max):
        res = bench.result("m", 4, [0.5, 1.5], "u", 2.0, 3, "cpu")
    assert json.loads(json.dumps(res)) == {"metric": "m", "value": 4.0, "unit": "u", "vs_baseline": 2.0,
                                           "runs_s": [0.5, 1.5], "stage_timing": timing,
                                           "fuse_b_max": fuse_b_max, "device": "cpu"}


@pytest.mark.slow
def test_pins_recomputed_through_jax():
    """`bench.py:263-361` in the JAX package at G = 2, P = 2, (1, 2)."""
    assert _jax_proof_hashes() == PROOF_SHA256


def _jax_proof_hashes() -> list:
    import jax.numpy as jnp

    from mental_poker_tpu.crypto import elgamal, sigma_device as sd
    from mental_poker_tpu.crypto import transcript_jax as dt
    from mental_poker_tpu.crypto.transcript import MASKING_RNG_SEED, REMASKING_RNG_SEED, REVEAL_RNG_SEED
    from mental_poker_tpu.ops import curve as curve_mod
    from mental_poker_tpu.ops.curve import PointP
    from mental_poker_tpu.utils.rand import GameRng, ints_to_limbs

    N = M_ * N_
    cv = curve_mod.stark_curve()
    fr = cv.fr
    q = cv.host.order
    rng = GameRng(11)
    gens = cv.from_host_points([cv.host.rand_point(rng.rng) for _ in range(G)])
    sks = rng.scalar_limbs(q, (G, P), fr.L)
    gens_p = PointP(*(jnp.broadcast_to(c[:, None], (G, P, c.shape[-1])) for c in gens))
    pks = cv.scalar_mul(jnp.asarray(sks), gens_p)
    agg_sk_int = [
        sum(int(sum(int(v) << (16 * i) for i, v in enumerate(sks[g, p]))) for p in range(P)) % q for g in range(G)
    ]
    agg_pk = cv.scalar_mul(jnp.asarray(ints_to_limbs(agg_sk_int, fr.L)), gens)
    L = fr.L
    flat_b = lambda Pt, reps: PointP(*(jnp.repeat(c, reps, axis=0) for c in Pt))
    g_b, pk_b = flat_b(gens, N), flat_b(agg_pk, N)
    cards = elgamal.rand_plaintexts(cv, rng, G * N)

    alphas = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    c0 = cv.scalar_mul(alphas, g_b)
    c1 = cv.add(cards, cv.scalar_mul(alphas, pk_b))
    stmt_b = cv.add(c1, cv.neg(cards))
    ks = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    prf = sd.cp_prove_dev(cv, dt.init(MASKING_RNG_SEED, (G * N,)), g_b, pk_b, c0, stmt_b, alphas, ks)
    betas = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    r0 = cv.scalar_mul(betas, g_b)
    r1 = cv.scalar_mul(betas, pk_b)
    d0 = cv.add(c0, r0)
    ks2 = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    prf2 = sd.cp_prove_dev(cv, dt.init(REMASKING_RNG_SEED, (G * N,)), g_b, pk_b, r0, r1, betas, ks2)
    M = G * P * N
    d0_b = PointP(*(jnp.repeat(c.reshape(G, 1, N, L), P, axis=1).reshape(M, L) for c in d0))
    sk_b = jnp.broadcast_to(jnp.asarray(sks)[:, :, None, :], (G, P, N, fr.L)).reshape(M, fr.L)
    tokens = cv.scalar_mul(sk_b, d0_b)
    g_bb = flat_b(gens, P * N)
    pk_pl = PointP(*(jnp.repeat(c[:, :, None], N, axis=2).reshape(M, L) for c in pks))
    ks3 = jnp.asarray(rng.scalar_limbs(q, (M,), fr.L))
    prf3 = sd.cp_prove_dev(cv, dt.init(REVEAL_RNG_SEED, (M,)), d0_b, g_bb, tokens, pk_pl, sk_b, ks3)
    return [proof_sha256(p) for p in (prf, prf2, prf3)]
