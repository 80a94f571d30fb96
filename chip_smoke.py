#!/usr/bin/env python3
"""Chip smoke run of the PyTorch/H100 port (`mental_poker_tpu_torch`).

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 chip_smoke.py                 # the full run
    python3 chip_smoke.py --profile DIR   # also trace one B=128 prove+verify and one multigame flow

Phases (every failure exits non-zero; nothing is caught and ignored):

1. Build: every CUDA kernel from `mental_poker_tpu_torch/csrc/`, one nvcc
   per source, all at once; `point_add_kernel`'s instructions counted in
   its SASS (`cuobjdump -sass`), for phase 4's bound.
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, limb for limb, plus a few results against host bigints;
   the lane-MSM kernel also at the edges of its thread mapping on both
   curves (S = 1, 2, 3, 31, 32, 33 and 1,000 statements of 3 points, and
   one statement of one point), first and last statements against host
   bigints.
3. The main path: a B=128 batch of 52-card decks on the Stark curve at
   (m, n) = (2, 26), permuted and remasked, proved and verified; then B=1;
   then a tampered deck, which must fail with "Hadamard Product (5.1)".
   Launch counts are read around one B=128 and one B=1 prove+verify. A (2, 4) proof made
   on the card must equal the same proof made on the CPU by the plain
   versions, leaf for leaf.
4. Times: prove+verify at B=128 and B=1, and each kernel at its main-path
   shape beside its plain version and its bound (`point_add`'s from the
   IMAD instructions of its SASS; `mont_mul` and `point_add` on inputs
   cycled through copies larger than twice the L2, so that they come from
   HBM as their bytes bounds assume); the lane-MSM kernel at
   each of its five main-path shapes and at one statement of one point.
   With `--profile DIR`, one B=128 prove+verify at `msm_nc = 1` is traced
   and each kernel's device time, summed over its launches, goes into its
   row (`device_ms_b128`).
5. The protocol path (second slice): the window-fold kernel against its
   plain version (Stark W = 63 and BLS12-377 W = 64, S = 1, 2, 3, 4, 5, 31,
   32, 33, 128 and 1,000: the edges of its four-statement blocks; first and
   last statements against host bigints); the
   gather engine against the lane engine at one statement of 3, 4, 26 and 52
   points; the host Bayer-Groth `ShuffleArgument` proving and verifying a
   52-card deck at (2, 26) with a statement from the port's `DLCards`,
   cross-verified both ways with the staged verifier and rejecting a
   substituted deck; and the reference's `round.rs` game (`play_round`,
   (2, 26), 4 players, 4 shuffles). Launch counts are read around the
   argument and around the round; the argument must launch the fold kernel.
   The engine rule: both engines timed at one statement of 1 to 15 points.
6. The chunked MSM (third slice): its kernel against its plain version
   (phase 2d) at every shape the staged flow gives it at `msm_nc = 8` (the
   five B=128 shapes after the wide split, the verifier's B=1 combos), at
   Stark S = 3, N = 5, NC = 4 and at two BLS12-377 shapes, and at the edges
   of the window kernel's thread mapping on both curves (every NC from 1 to
   8, and NC 9, 16, 33, 52 and 64, where each thread's stack is deeper, at
   S = 1 and 33, with and without pad slots; S = 2, 3, 31, 32 and 1,000 at
   NC = 8 and 3), window sums limb for limb and their folds against host
   bigints; timed at the prover diagonals (the table and the
   window kernel apart) and at the B=1 verifier's shapes; the main path again with
   `msm_nc = 8` (phase 3b: the B=128 proof must equal the nc = 1 proof leaf
   for leaf, with the chunked and fold kernels launched and the lane kernel
   not; the tampered deck rejected at nc = 8 too); and the reference's
   parameter sweep (`run_sweep`, N = 300 cards at five (m, n) splits on
   BLS12-377) with `msm_nc = 8`, every point verified, then the kernel
   against plain at every shape the sweep launched it at. A chunked launch
   of phase 3b or of the tampered check at a shape phase 2d did not compare
   fails the run.
7. The port bench's paths (`mental_poker_tpu_torch/bench.py`, sixth
   slice): the multigame flow at full width (64 games of 8 players at
   (2, 26): masks, remasks and every player's reveal tokens with
   Chaum-Pedersen proofs made and verified on the card by
   `crypto/sigma_device.py`, the cards unmasked), every check true, launch
   counts and peak device memory read around one flow, `mont_mul` and
   `point_add` held against their plain versions at every lane count that
   flow launched them at (phases 2a and 2b cover 65,536 lanes only), one
   tampered reveal response rejected in its lane alone, games per second
   over three flows, and the flow at G = 2, P = 3, (2, 2) equal on the card
   and on the CPU proof tensor for proof tensor (with `--profile DIR`, one
   more flow traced: device busy time and idle share); the 1,024-point MSM against host bigints;
   and one 1,024-card deck at (16, 64) proved and verified (a tampered deck
   rejected), with the per-statement MSM kernel held against its plain
   version at every shape it ran at there that phase 2c did not compare.
   7b (`hash_phase`): the transcript kernels, Blake2s and the ChaCha20 draw
   (`csrc/hash.cu`), held against their plain versions at every shape
   phase 3 (B=128, B=1) and the multigame flow launched them at, and at
   the benchmark cells' shapes (`HASH_CELLS`, printed by cell); their
   launch counts sit in the kernels' JSON line.
8. The parallel layer (`mental_poker_tpu_torch/parallel/`, seventh slice;
   `parallel_phase`): at world size 1 on NCCL, the path alone with its
   launch counts read around it (the sharded remask, deck MSM, window MSM,
   prefix product and commit on phase 3's B=128 decks, the deck MSM again
   at `msm_nc = 8`, the dry run's tier 2: the batch through `shard_batch` /
   `gather_batch`), every kernel launched; tier 2's proof equal to phase
   3's leaf for leaf; the remask, deck MSM, window MSM and prefix product
   held against their unsharded paths and timed beside them; then at D =
   1, 2 and 4 ranks every rank's local step in turn (`run_ranks`), the
   gathers emulated, each combined result equal to world size 1; and every
   kernel launch at a shape no earlier phase compared held against its
   plain version.
9. The bench's knobs (eighth slice; `bench_phase`): the bench's shuffle52
   at B = 128, (2, 26) with the stage report on (`MPTPU_STAGE_TIMING`),
   launch counts read around it alone: every stage named, each stage's
   calls the flow's, their steady times summed within the mean run, and
   phase 3's batch proved with timing on equal to phase 3's proof leaf for
   leaf; a timed and a traced run of the same set-up (`MPTPU_PROFILE`):
   the stage report printed before the trace and without the traced run,
   the Chrome trace written, the device-busy ms, idle share (also against
   phase 3's untraced median), device ms by kernel and by stage and the
   top operations printed, the three staged kernels among them; `bench.main()` at `MPTPU_BENCH_BATCH=1` and at
   `MPTPU_BENCH_SMOKE=1`; and the dp scaling curve (`parallel/scaling.py`)
   at world size 1 on NCCL, B = 128, (2, 26). Every launch at a shape no
   earlier phase compared is held against its plain version.
10. The fused latency mode (ninth slice; `fused_phase`): with
   `fuse_b_max` set, the staged prove and verify captured as CUDA graphs
   (`arguments/fused.py`) and replayed. (a) Phase 3's B=1 deck at
   `msm_nc = 1`: the fused proof equal to phase 3's B=1 proof leaf for
   leaf, every flag true, phase 3's tampered deck rejected; each graph's
   capture time, the kernel launches its capture recorded (equal to phase
   3's B=1 counts; a draw one launch, where the staged draw loops), the
   median of five replayed prove+verify beside phase 3's staged B=1
   median, one replay traced (device-busy ms, idle share)
   and `FUSED_MISSES`. (b) A second statement (another seed and aggregate
   key) through the same graphs equal to its staged proof, (a)'s proof
   unchanged. (c) B = 4 with `fuse_b_max = 4` equal to staged B = 4. (d)
   B=1 at `msm_nc = 8` equal to (a)'s proof, the chunked and fold kernels
   inside a graph. (e) `play_round(seed=7, m=2, n=26)` fused, its cards
   phase 5's. (f) `bench.main()` at `MPTPU_BENCH_BATCH=1` with
   `MPTPU_FUSE_B=1`. Every launch at a shape no earlier phase compared is
   held against its plain version; the B=1 capture's transcript-kernel
   shapes must be the ones phase 7b compared for `shuffle52.table`.

Every phase runs with `msm_nc = 1` (the per-statement MSM kernel) unless it
says otherwise, whatever `MPTPU_MSM_NC` holds.

Output: progress lines, then one JSON line listing the kernels, then the
card's name and power limit, then `{"ok": true, "device": {...}}` last.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM. Memory: 3.35 TB/s of HBM (NVIDIA's data sheet,
# at 700 W). Integer: the CUDA C++ Programming Guide's throughput table gives
# compute capability 9.0 64 results per clock per SM for 32-bit integer
# multiply and multiply-add (IMAD), half its float32 FMA rate; `imad_rate`
# multiplies that by the card's SM count and its maximum SM clock. The model
# bounds take two IMADs per 32x32->64-bit word product (low and high half);
# `point_add`'s bound counts the IMADs of its SASS instead (phase 1).
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_SM_CLOCK = 64
IMAD_PER_S = None  # set by main() from the card
SM_CLOCK_HZ = None  # the card's maximum SM clock, set by main(); a dependent
# chain in one thread issues at most one instruction per clock

# Montgomery products of the cheapest complete formulas (Renes-Costello-
# Batina 2015) on the Stark curve, where a = 1 makes the products by a free:
# an addition (Alg. 1) 12 + 2 by 3b, a doubling (Alg. 3) 8 + 3 squares + 2
# by 3b. The kernels run Alg. 1 for both, with the products by a
# specialised away (a = 1 on Stark, a = 0 on BLS12-377): 14 each.
ADD_PRODUCTS = 14
DBL_PRODUCTS = 13
# Products on the critical path of one point operation when a lane group
# spreads each of Alg. 1's three layers of independent products over its
# lanes (csrc/fold.cuh): one product per layer.
GROUP_CHAIN_PRODUCTS = 3

STAGED_KERNELS = ("mont_mul", "point_add", "msm_lanes")  # the staged flow's kernels at nc = 1
HASH_KERNELS = ("blake2s", "chacha_draw")  # the transcript's kernels (csrc/hash.cu), every flow
CHUNKED_KERNELS = ("mont_mul", "point_add", "msm_chunked", "fold_windows")  # ... and at nc = 8
NC = 8  # points per step of the chunked MSM on its paths
BATCH = 128  # decks per prove+verify batch, as bench.py's shuffle52 mode
REPS = 5  # timed prove+verify repetitions per batch size
WINDOW = 8  # fixed-base window bits, as bench.py:38


def log(msg: str) -> None:
    print(msg, flush=True)


def require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


def word_products(L: int) -> int:
    """32-bit word products of one CIOS Montgomery multiply, NW = L/2 words."""
    nw = L // 2
    return 2 * nw * nw + nw


def ptxas_summary(text: str) -> list:
    """One line per kernel of an `nvcc -Xptxas -v` log: its name with its
    template arguments (`msm_chunked_window_kernel<8,1>`: NW = 8 words,
    a-case 1), its registers and its spills."""
    import re

    out, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_Z(\d+)(\w+)'", line)
        if m:
            ident, rest = m.group(2)[:int(m.group(1))], m.group(2)[int(m.group(1)):]
            args = re.match(r"I((?:Li\d+E)+)E", rest)
            name = ident + (f"<{','.join(re.findall(r'Li(\d+)E', args.group(1)))}>" if args else "")
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and name:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; {spill}")
            name, spill = None, ""
    return out


def sm_clock_hz() -> float:
    """The card's maximum SM clock."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def imad_rate() -> float:
    """Peak IMADs per second: 64 per SM per clock at the maximum SM clock."""
    import torch

    return IMAD_PER_SM_CLOCK * torch.cuda.get_device_properties(0).multi_processor_count * SM_CLOCK_HZ


def bound(ops_imad: float, nbytes: float):
    t_ops = ops_imad / IMAD_PER_S
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Median of `reps` CUDA-event timings of fn() (after `warm` calls)."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def cold(fn, args: tuple, nbytes: int):
    """A call of fn(*args) with no arguments that cycles through copies of
    `args`, enough of them that the bytes the calls move between two uses
    of one copy (`nbytes` a call) exceed twice the card's L2: each call
    reads its inputs from HBM, as a bytes bound at the HBM rate assumes.
    Returns (the call, the number of copies)."""
    import itertools

    import torch

    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size", 50 * 2**20)
    n = max(2, -(-2 * l2 // nbytes) + 1)
    clone = lambda x: type(x)(*map(torch.clone, x)) if isinstance(x, tuple) else x.clone()
    copies = itertools.cycle([args] + [tuple(clone(x) for x in args) for _ in range(n - 1)])
    return (lambda: fn(*next(copies))), n


# msm_chunked's two launches, timed apart (device-side names; each
# wrapper's are `profiling.KERNEL_FUNCTIONS`)
CHUNKED_SPLIT = {"table": ("msm_table_kernel",), "window": ("msm_chunked_window_kernel",)}


def kernel_ms_by(fn, groups: dict, reps: int = 10) -> dict:
    """Device time (ms) one fn() call spends in each group of kernels
    (`groups`: key -> device-side names), the mean over `reps` calls traced
    by torch.profiler after a warm call. Unlike `cuda_ms` it leaves out the
    host's time between launches (the wrapper's Python work), which a kernel
    of a few microseconds cannot hide."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mental_poker_tpu_torch import profiling

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = profiling.device_spans(prof)
    return {key: profiling.device_ms(spans, names) / reps for key, names in groups.items()}


def kernel_ms(fn, names, reps: int = 10) -> float:
    """`kernel_ms_by` for one group of kernels."""
    return kernel_ms_by(fn, {"": names}, reps)[""]


def max_abs_err(a, b) -> float:
    import torch

    return max(float((x.long() - y.long()).abs().max()) if x.numel() else 0.0 for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", default=None, help="directory for a torch.profiler table of one batch")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mental_poker_tpu_torch")):
        print("chip_smoke: run it from the repository root (package not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)

    from mental_poker_tpu_torch import bench, config, params, profiling
    from mental_poker_tpu_torch.arguments import device_api
    from mental_poker_tpu_torch.crypto import elgamal
    from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
    from mental_poker_tpu_torch.crypto.errors import HADAMARD, ProofVerificationError
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.ops import field as field_mod
    from mental_poker_tpu_torch.ops.cuda import build
    from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
    from mental_poker_tpu_torch.ops.cuda import field as cuda_field
    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
    from mental_poker_tpu_torch.ops.curve import PointP, bls12_377_g1, map_point, stark_curve
    from mental_poker_tpu_torch.parallel.sharding import leaves
    from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs

    global IMAD_PER_S, SM_CLOCK_HZ
    started = time.perf_counter()
    dev = torch.device("cuda")
    config.set_config(config.RuntimeConfig(msm_nc=1))  # phases with nc = 8 say so
    card = bench.device_name(dev)  # nvidia-smi's name and power limit
    SM_CLOCK_HZ = sm_clock_hz()
    IMAD_PER_S = imad_rate()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
        f"peak {IMAD_PER_S / 1e12:.2f} T IMAD/s")

    # ---------------------------------------------------------------- 1. build
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s for {built or 'nothing (cached)'}")
    for src in build.SOURCES:
        for line in ptxas_summary(build.build_log(src)):
            log(f"  ptxas {src}: {line}")
    # point_add's integer multiply-adds per addition, from its SASS: one
    # addition a thread, so the static counts of the Stark instantiation
    # (NW = 8 words, a = 1) are its dynamic counts when it has no loop
    sass = sass_counts("point_add_kernel", "curve.cu")
    for fn_name, counts in sass.items():
        log(f"  sass curve.cu {fn_name}: {counts}; IMAD instructions {imad_count(counts)}")
    stark_add = [c for fn_name, c in sass.items() if "ILi8ELi1E" in fn_name]
    require(len(stark_add) == 1, f"point_add_kernel<8, 1> not found once in the SASS: {list(sass)}")
    add_imads = imad_count(stark_add[0])

    cv = stark_curve()
    fq, fr = cv.fq, cv.fr
    q = cv.host.order
    npr = np.random.default_rng(2026)
    kernels = {}

    def rand_field(f, n):
        """n uniform reduced Montgomery-form elements (random limbs, reduced
        mod p on the host) with 0, 1 and p-1 at the front."""
        vals = [0, 1, f.p - 1] + [int.from_bytes(npr.bytes(48), "little") % f.p for _ in range(n - 3)]
        return f.tensor(f.from_int_array(vals), dev), vals

    # --------------------------------------------- 2a. mont_mul vs plain
    errs = 0.0
    for f in (field_mod.stark_fq(), field_mod.stark_fr(), field_mod.bls12_377_fq()):
        a, av = rand_field(f, 65536)
        b, bv = rand_field(f, 65536)
        b = b.flip(0)
        bv = bv[::-1]
        got = cuda_field.mont_mul(f, a, b)
        want = cuda_field.mont_mul_plain(f, a, b)
        torch.cuda.synchronize()
        err = max_abs_err([got], [want])
        errs = max(errs, err)
        host = got[:8].cpu().numpy()
        for i in range(8):
            require(f.to_int(host[i]) == av[i] * bv[i] % f.p, (f.name, i))
        for i in range(-4, 0):
            require(f.to_int(got[i].cpu().numpy()) == av[i] * bv[i] % f.p, (f.name, i))
        if err:
            raise AssertionError(f"mont_mul {f.name}: kernel differs from plain by {err}")
        log(f"mont_mul {f.name} L={f.L}: 65536 products equal to plain; host bigints agree")
    kernels["mont_mul"] = dict(max_abs_err=errs)
    elementwise_compared = {("mont_mul", f.name, 65536)
                            for f in (field_mod.stark_fq(), field_mod.stark_fr(), field_mod.bls12_377_fq())}

    # -------------------------------------------- 2b. point_add vs plain
    n_add = 65536
    k1 = torch.as_tensor(GameRng(3).scalar_limbs(q, (n_add,), fr.L).astype(np.int32), device=dev)
    k2 = torch.as_tensor(GameRng(4).scalar_limbs(q, (n_add,), fr.L).astype(np.int32), device=dev)
    g = params.setup(GameRng(5), 2, 26, c=WINDOW, device=dev)
    P = g.enc.gen_table.mul(k1)
    Q = g.enc.gen_table.mul(k2)
    # edge cases at the front: identity + P, P + (-P), P + P, identity + identity
    ident = cv.identity((n_add,), dev)
    negP = cv.neg(P)

    def sel(A, B_, i):
        """A at batch index i, B_ elsewhere."""
        at_i = (torch.arange(n_add, device=dev) == i)[:, None]
        return PointP(*(torch.where(at_i, x, y) for x, y in zip(A, B_)))

    Pm, Qm = P, Q
    Pm = sel(ident, Pm, 0)
    Qm = sel(negP, Qm, 1)
    Qm = sel(P, Qm, 2)
    Pm = sel(ident, Pm, 3)
    Qm = sel(ident, Qm, 3)
    got = cuda_curve.point_add(cv, Pm, Qm)
    want = cuda_curve.point_add_plain(cv, Pm, Qm)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"point_add: kernel differs from plain by {err}")
    hp = cv.to_host_points(PointP(*(t[:16] for t in Pm)))
    hq = cv.to_host_points(PointP(*(t[:16] for t in Qm)))
    hs = cv.to_host_points(PointP(*(t[:16] for t in got)))
    for i in range(16):
        require(hs[i] == cv.host.add(hp[i], hq[i]), i)
    require(hs[1][2] and hs[3][2], "P + (-P) and O + O must be the identity")
    kernels["point_add"] = dict(max_abs_err=err)
    elementwise_compared.add(("point_add", cv.host.name, n_add))
    log(f"point_add: {n_add} additions equal to plain (identity, P+(-P), P+P included); host bigints agree")

    # -------------------------------------------- 2c. msm_lanes vs plain
    B = BATCH
    shapes = [("combo (4,52)", B * 4, 52), ("combo (7,8)", B * 7, 8), ("combo (2,4)", B * 2, 4),
              ("combo (2,1)", B * 2, 1), ("prover diagonals [B,8,52]", B * 8, 52)]
    errs = 0.0
    lane_inputs = []
    for name, S, N in shapes:
        kk = torch.as_tensor(GameRng(S + N).scalar_limbs(q, (S, N), fr.L).astype(np.int32), device=dev)
        kk[0, 0] = 0  # edge scalars: 0, 1, q-1
        kk[0, 1 % N] = fr.small_int_limbs(1, dev)
        pts = g.enc.gen_table.mul(torch.as_tensor(GameRng(7 + N).scalar_limbs(q, (S, N), fr.L).astype(np.int32), device=dev))
        if N > 2:
            kk[1, 2] = fr.tensor(ints_to_limbs([q - 1], fr.L)[0], dev)
            pts = map_point(lambda t: t.clone(), pts)
            for t, v in zip(pts, cv.identity((), dev)):
                t[1, 0] = v  # an identity point
        got = cuda_msm.msm_lanes(cv, pts, kk)
        want = cuda_msm.msm_lanes_plain(cv, pts, kk)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        errs = max(errs, err)
        if err:
            raise AssertionError(f"msm_lanes {name}: kernel differs from plain by {err}")
        # host bigint check of two statements
        hk = kk[:2].cpu().numpy()
        hpts = [cv.to_host_points(PointP(*(t[s] for t in pts))) for s in range(2)]
        hout = cv.to_host_points(PointP(*(t[:2] for t in got)))
        for s in range(2):
            acc = cv.host.identity
            for i in range(N):
                kint = sum(int(v) << (16 * j) for j, v in enumerate(hk[s, i]))
                acc = cv.host.add(acc, cv.host.mul(kint, hpts[s][i]))
            require(hout[s] == acc, (name, s))
        lane_inputs.append((name, pts, kk))
        log(f"msm_lanes {name} [S={S}, N={N}]: equal to plain; host bigints agree")
    edge_inputs, lanes_compared = lanes_edge_phase(dev, g)
    lane_inputs += edge_inputs
    lanes_compared |= {(cv.host.name, S, N) for _, S, N in shapes}
    kernels["msm_lanes"] = dict(max_abs_err=errs)

    # ------------------------------------- 2d. msm_chunked vs plain
    # 2c's shapes, and the verifier's combos at B=1 (the tampered deck at nc = 8)
    shapes_b1 = [(f"{name} at B=1", S // B, N) for name, S, N in shapes if name.startswith("combo")]
    kernels["msm_chunked"], compared = chunked_phase(dev, g, shapes + shapes_b1)
    compared |= chunked_edge_phase(dev, g)

    def all_compared(seen, where):
        missing = sorted(seen - compared)
        if missing:
            raise AssertionError(f"{where} launched the chunked kernel at shapes not held against plain: {missing}")

    # ------------------------------------------------------ 3. the main path
    m, n = 2, 26
    N = m * n
    rng = GameRng(1234)
    t0 = time.perf_counter()
    g = params.setup(rng, m, n, c=WINDOW, device=dev)
    torch.cuda.synchronize()
    log(f"setup (window {WINDOW} tables for {n + 4} bases): {time.perf_counter() - t0:.2f} s")

    def make_batch(batch: int, seed: int):
        r = GameRng(seed)
        # random cards: c0 = a G, c1 = b G with uniform a, b, made on the card
        ab = torch.as_tensor(r.scalar_limbs(q, (2, batch, N), fr.L).astype(np.int32), device=dev)
        deck = Ciphertexts(g.enc.gen_table.mul(ab[0]), g.enc.gen_table.mul(ab[1]))
        pi = torch.as_tensor(np.stack([r.permutation(N) for _ in range(batch)]).astype(np.int64), device=dev)
        rho = torch.as_tensor(r.scalar_limbs(q, (batch, N), fr.L).astype(np.int32), device=dev)
        permuted = Ciphertexts(*(map_point(lambda t: torch.gather(t, 1, pi[..., None].expand(t.shape)), c) for c in deck))
        shuffled = elgamal.cipher_add(cv, permuted, elgamal.encrypt_zero(g.enc, g.agg_table, rho))
        rand = device_api.sample_shuffle_rand(r, m, n, fr.L, q, batch=batch, device=dev)
        return deck, shuffled, pi, rho, rand

    def prove_verify(batch_data):
        deck, shuffled, pi, rho, rand = batch_data
        proof = device_api.prove_shuffle(cv, m, n, g.keys, deck, shuffled, pi, rho, rand)
        checks = device_api.verify_shuffle(cv, m, n, g.keys, deck, shuffled, proof)
        torch.cuda.synchronize()
        return proof, checks

    data = make_batch(B, 77)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prove_verify(data)  # first call: library loads, allocator warm-up
    log(f"first prove+verify at B={B}: {time.perf_counter() - t0:.2f} s")

    cuda_ops.reset_launches()
    hash_seen = {flow: set() for flow in ("staged", "b1", "fused")}  # phase 7b's shapes, by flow
    t0 = time.perf_counter()
    with hash_shapes(hash_seen["staged"]):
        proof, checks = prove_verify(data)
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_ops.LAUNCHES)
    ok = [bool(c.all()) for c in checks]
    log(f"B={B}: checks {dict(zip(checks._fields, ok))}; launches during prove+verify: {launches}")
    if not all(ok):
        raise AssertionError("the verifier rejected an honest batch")
    for k in STAGED_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path")
        kernels[k]["launches"] = launches[k]
    if launches["fold_windows"] or launches["msm_chunked"]:
        raise AssertionError("at nc = 1 the staged flow launched the fold or the chunked kernel "
                             "(its MSMs all have S >= 2, so no gather engine)")
    times = [first_ms]
    for _ in range(REPS - 1):
        t0 = time.perf_counter()
        prove_verify(data)
        times.append((time.perf_counter() - t0) * 1e3)
    pv_ms = sorted(times)[len(times) // 2]
    log(f"prove+verify B={B}: {pv_ms:.1f} ms per batch (runs {[round(t, 1) for t in times]}), "
        f"{B / pv_ms * 1e3:.2f} pairs/s")

    # ------------------------------------------- 3b. the main path at nc = 8
    seen8 = set()
    with config.override(msm_nc=NC), chunked_shapes(seen8):
        prove_verify(data)
        cuda_ops.reset_launches()
        t0 = time.perf_counter()
        proof8, checks8 = prove_verify(data)
        times8 = [(time.perf_counter() - t0) * 1e3]
        launches8 = dict(cuda_ops.LAUNCHES)
        for _ in range(2):
            t0 = time.perf_counter()
            prove_verify(data)
            times8.append((time.perf_counter() - t0) * 1e3)
    log(f"B={B}, msm_nc={NC}: launches during prove+verify: {launches8}")
    if not all(bool(c.all()) for c in checks8):
        raise AssertionError(f"the verifier rejected an honest batch at msm_nc = {NC}")
    for k in CHUNKED_KERNELS:
        if launches8[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the main path at msm_nc = {NC}")
    if launches8["msm_lanes"] or launches8["fold_windows"] != launches8["msm_chunked"]:
        raise AssertionError("at msm_nc = 8 every variable-base MSM must be one chunked launch and one fold")
    diff = [i for i, (a_, b_) in enumerate(zip(leaves(proof), leaves(proof8))) if not torch.equal(a_, b_)]
    if diff or len(leaves(proof)) != len(leaves(proof8)):
        raise AssertionError(f"the msm_nc = {NC} proof differs from the nc = 1 proof at leaves {diff}")
    all_compared(seen8, f"the main path at msm_nc = {NC}")
    kernels["msm_chunked"]["launches"] = launches8["msm_chunked"]
    kernels["fold_windows"] = dict(launches_nc8=launches8["fold_windows"])
    pv8_ms = sorted(times8)[1]
    log(f"prove+verify B={B}, msm_nc={NC}: {pv8_ms:.1f} ms per batch (runs {[round(t, 1) for t in times8]}), "
        f"{B / pv8_ms * 1e3:.2f} pairs/s; the proof equals the nc = 1 proof ({len(leaves(proof8))} leaves)")

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            prove_verify(data)
        averages = prof.key_averages()
        table = averages.table(sort_by="device_time_total", row_limit=30)
        with open(os.path.join(args.profile, "profile_b%d.txt" % B), "w") as fh:
            fh.write(table)
        log(table)
        device_ms = profiling.kernel_device_ms(profiling.device_spans(prof))
        for k, v in device_ms.items():
            if k in kernels:
                kernels[k]["device_ms_b128"] = v
        log(f"device time per B={B} prove+verify at msm_nc = 1, by kernel (ms): {device_ms}")

    deck, shuffled, pi, rho, rand = data
    cut = lambda c: Ciphertexts(*(map_point(lambda t: t[:1], p) for p in c))
    data1 = (cut(deck), cut(shuffled), pi[:1], rho[:1], type(rand)(*(t[:1] for t in rand)))
    prove_verify(data1)
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    with hash_shapes(hash_seen["b1"]):
        proof1, checks1 = prove_verify(data1)
    times1 = [(time.perf_counter() - t0) * 1e3]
    launches1 = dict(cuda_ops.LAUNCHES)
    if not all(bool(c.all()) for c in checks1):
        raise AssertionError("the verifier rejected an honest B=1 deck")
    log(f"B=1: launches during prove+verify: {launches1}")
    for k in STAGED_KERNELS:
        if launches1[k] <= 0:
            raise AssertionError(f"kernel {k} was not launched on the B=1 path")
        kernels[k]["launches_b1"] = launches1[k]
    for k in HASH_KERNELS:
        require(launches[k] > 0 and launches1[k] > 0, f"the staged flow did not launch {k}")
        kernels[k] = dict(launches=launches[k], launches_b1=launches1[k])
    for _ in range(REPS - 1):
        t0 = time.perf_counter()
        prove_verify(data1)
        times1.append((time.perf_counter() - t0) * 1e3)
    pv1_ms = sorted(times1)[len(times1) // 2]
    log(f"prove+verify B=1: {pv1_ms:.1f} ms (runs {[round(t, 1) for t in times1]}), {1e3 / pv1_ms:.3f} pairs/s")

    # tampered deck: two output cards swapped; at nc = 1 and at nc = 8
    bad_c0 = map_point(lambda t: t[:, [1, 0] + list(range(2, N))], data1[1].c0)
    bad = Ciphertexts(bad_c0, data1[1].c1)
    seen_bad = set()
    for nc in (1, NC):
        with config.override(msm_nc=nc), chunked_shapes(seen_bad):
            checks_bad = device_api.verify_shuffle(cv, m, n, g.keys, data1[0], bad, proof1)
        try:
            device_api.raise_by_flags(checks_bad)
        except ProofVerificationError as e:
            if e.name != HADAMARD:
                raise AssertionError(f"tampered deck failed with {e.name!r} at msm_nc = {nc}, "
                                     f"expected {HADAMARD!r}") from e
            log(f"tampered deck rejected at msm_nc = {nc}: {e}")
        else:
            raise AssertionError(f"a tampered deck was accepted at msm_nc = {nc}")
    if not seen_bad:
        raise AssertionError(f"the tampered deck's check at msm_nc = {NC} did not reach the chunked kernel")
    all_compared(seen_bad, f"the B=1 verifier at msm_nc = {NC}")

    # the card's (2, 4) proof equals the CPU plain versions' proof
    ms_, ns_ = 2, 4
    gs = params.setup(GameRng(99), ms_, ns_, c=4, device=dev)
    gc = params.setup(GameRng(99), ms_, ns_, c=4, device="cpu")
    r = GameRng(100)
    Ns = ms_ * ns_
    ab = r.scalar_limbs(q, (2, 2, Ns), fr.L).astype(np.int32)
    pis = np.stack([r.permutation(Ns) for _ in range(2)]).astype(np.int64)
    rhos = r.scalar_limbs(q, (2, Ns), fr.L).astype(np.int32)
    rands = device_api.sample_shuffle_rand(r, ms_, ns_, fr.L, q, batch=2, device="cpu")
    proof_leaves = []
    for gg, d in ((gs, dev), (gc, torch.device("cpu"))):
        abt = torch.as_tensor(ab, device=d)
        dk = Ciphertexts(gg.enc.gen_table.mul(abt[0]), gg.enc.gen_table.mul(abt[1]))
        pit = torch.as_tensor(pis, device=d)
        rht = torch.as_tensor(rhos, device=d)
        perm = Ciphertexts(*(map_point(lambda t: torch.gather(t, 1, pit[..., None].expand(t.shape)), c) for c in dk))
        sh = elgamal.cipher_add(cv, perm, elgamal.encrypt_zero(gg.enc, gg.agg_table, rht))
        rd = type(rands)(*(t.to(d) for t in rands))
        pr = device_api.prove_shuffle(cv, ms_, ns_, gg.keys, dk, sh, pit, rht, rd)
        proof_leaves.append([t.cpu() for t in leaves(pr)])
    if any(not torch.equal(a_, b_) for a_, b_ in zip(*proof_leaves)):
        raise AssertionError("the card's (2, 4) proof differs from the CPU plain versions' proof")
    log(f"(2, 4) proof on the card equals the CPU plain proof: {len(proof_leaves[0])} leaves")

    # -------------------------------------------------------------- 4. times
    f = fq
    n_mm = 2 * 2 * B * N  # the deck-root inversion: c0 and c1 of both decks
    a, _ = rand_field(f, n_mm)
    b, _ = rand_field(f, n_mm)
    # the kernel timed on inputs out of L2 (`cold`), as its bytes bound
    # at the HBM rate assumes
    mm, copies = cold(lambda x, y: cuda_field.mont_mul(f, x, y), (a, b), n_mm * 3 * f.L * 4)
    ms = cuda_ms(mm, 20, 3)
    dms = kernel_ms(mm, profiling.KERNEL_FUNCTIONS["mont_mul"])
    plain = cuda_ms(lambda: cuda_field.mont_mul_plain(f, a, b), 5)
    bms, by = bound(n_mm * word_products(f.L) * 2, n_mm * 3 * f.L * 4)
    kernels["mont_mul"].update(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by,
                               shape=f"{n_mm} Stark Fq elements", input_copies=copies)
    log(f"mont_mul [{n_mm} x L=16]: {ms:.4f} ms (device {dms:.4f} ms; inputs cycled through {copies} copies, "
        f"out of L2), plain {plain:.3f} ms, bound {bms:.5f} ms ({by})")

    n_pa = n_add
    pa, copies = cold(lambda x, y: cuda_curve.point_add(cv, x, y), (P, Q), n_pa * 9 * f.L * 4)
    ms = cuda_ms(pa, 20, 3)
    dms = kernel_ms(pa, profiling.KERNEL_FUNCTIONS["point_add"])
    plain = cuda_ms(lambda: cuda_curve.point_add_plain(cv, P, Q), 5)
    # the bound from the kernel's own SASS (phase 1); beside it the model of
    # two IMADs per 32-bit word product, 14 products an addition
    bms, by = bound(n_pa * add_imads, n_pa * 9 * f.L * 4)
    model_ms, _ = bound(n_pa * ADD_PRODUCTS * word_products(f.L) * 2, n_pa * 9 * f.L * 4)
    kernels["point_add"].update(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                bound_ms_model=model_ms, imads_per_add=add_imads, shape=f"{n_pa} additions",
                                input_copies=copies)
    log(f"point_add [{n_pa}]: {ms:.4f} ms (device {dms:.4f} ms; inputs cycled through {copies} copies, out of L2), "
        f"plain {plain:.3f} ms, bound {bms:.5f} ms ({by}; {add_imads} IMADs an addition from the SASS), the "
        f"two-IMADs-a-word-product model's {model_ms:.5f} ms; the bound over the device time {bms / dms:.2f}")

    # msm_lanes at every shape of phase 2c and at S = 1, N = 1 (the fold
    # alone, nearly); plain and bound at the prover diagonals
    c = cuda_msm.WINDOW
    W = cuda_msm.num_windows(cv)
    by_shape = {}
    for name, pts, kk in lane_inputs:
        S, Nm = kk.shape[0], kk.shape[1]
        ms = cuda_ms(lambda: cuda_msm.msm_lanes(cv, pts, kk), 10, 2)
        by_shape[f"{name}: S={S}, N={Nm}"] = ms
        log(f"msm_lanes [{name}: S={S}, N={Nm}]: {ms:.3f} ms")
        if not name.startswith("prover"):
            continue
        dms = kernel_ms(lambda: cuda_msm.msm_lanes(cv, pts, kk), profiling.KERNEL_FUNCTIONS["msm_lanes"])
        plain = cuda_ms(lambda: cuda_msm.msm_lanes_plain(cv, pts, kk), 1, 0)
        # per statement: the multiples tables, the window sums, the fold
        adds = S * Nm * ((1 << c) - 2) + S * W * Nm + S * W
        dbls = S * W * c
        products = adds * ADD_PRODUCTS + dbls * DBL_PRODUCTS
        bms, by = bound(products * word_products(f.L) * 2, (S * Nm * (3 * f.L + fr.L) + S * 3 * f.L) * 4)
        kernels["msm_lanes"].update(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by,
                                    shape=f"{name}: S={S}, N={Nm}")
        log(f"msm_lanes [{name}: S={S}, N={Nm}]: device {dms:.4f} ms, plain {plain:.1f} ms, bound {bms:.4f} ms ({by})")
    kernels["msm_lanes"]["ms_by_shape"] = by_shape

    # ------------------------------------------- 5. the protocol path
    kernels["fold_windows"].update(fold_phase(dev, g, kernels))
    engine_ms = gather_phase(dev, g)
    arg_s, arg_launches = argument_phase(dev)
    kernels["fold_windows"]["launches"] = arg_launches["fold_windows"]
    round_s, round_launches, round_opened = round_phase(dev)
    for k, v in round_launches.items():
        kernels[k]["launches_round"] = v

    # --------------------------------------------- 6. the parameter sweep
    sweep, sweep_launches = sweep_phase(dev, compared)
    kernels["msm_chunked"]["launches_sweep"] = sweep_launches

    # ------------------------------------------------- 7. the bench's paths
    multigame = multigame_phase(dev, g, elementwise_compared, args.profile)
    msm1024 = msm1024_phase(dev)
    deck1024 = deck1024_phase(dev, g, lanes_compared)
    for k in kernels:
        kernels[k]["launches_multigame"] = multigame["launches"][k]
        kernels[k]["launches_deck1024"] = deck1024["launches"][k]
    # 7b. the transcript kernels at the flows' and the benchmark cells' shapes
    hash_seen["game"] = set(multigame.pop("hash_shapes"))
    hash7 = hash_phase(dev, hash_seen)

    # --------------------------------------------------- 8. the parallel layer
    bls_name = bls12_377_g1().host.name
    compared8 = dict(
        elementwise=elementwise_compared | {tuple(key) for key in multigame["elementwise_lanes"]},
        lanes=lanes_compared | set(deck1024["shapes"]),
        chunked=compared,
        fold={(name, S) for name in (cv.host.name, bls_name) for S in EDGE_S + (BATCH,)},
    )
    parallel = parallel_phase(dev, g, data, proof, compared8, pv_ms, card)
    for k in kernels:
        kernels[k]["launches_parallel"] = parallel["launches"][k]

    # ------------------------------------------------ 9. the bench's knobs
    seen8 = parallel.pop("seen")  # phase 8 held each of these against plain
    compared9 = {k: compared8[k] | seen8[k] for k in compared8}
    bench9 = bench_phase(dev, g, data, proof, prove_verify, compared9, pv_ms)
    for k in kernels:
        kernels[k]["launches_bench"] = bench9["launches"][k]

    # ------------------------------------------- 10. the fused latency mode
    seen9 = bench9.pop("seen")  # phase 9 held each of these against plain
    fused10 = fused_phase(dev, g, data, data1, proof1, bad, launches1, pv1_ms, (round_s, round_opened),
                          {k: compared9[k] | seen9[k] for k in compared9}, hash_seen["fused"])
    for k in kernels:
        kernels[k]["launches_fused"] = fused10["launches"][k]
        kernels[k]["launches_fused_nc8"] = fused10["launches_nc8"][k]

    require(hash_seen["fused"] == hash7.pop("table_shapes"),
            f"the fused B=1 capture launched the transcript kernels at {sorted(hash_seen['fused'])}, "
            f"not at the shapes phase 7b compared for shuffle52.table")

    meta = {
        "mont_mul": ("mental_poker_tpu_torch/csrc/field.cu", "mental_poker_tpu/ops/pallas/field.py:128"),
        "point_add": ("mental_poker_tpu_torch/csrc/curve.cu", "mental_poker_tpu/ops/pallas/curve.py:94"),
        "fold_windows": ("mental_poker_tpu_torch/csrc/curve.cu", "mental_poker_tpu/ops/pallas/curve.py:146"),
        "msm_lanes": ("mental_poker_tpu_torch/csrc/msm.cu", "mental_poker_tpu/ops/pallas/msm.py:52"),
        "msm_chunked": ("mental_poker_tpu_torch/csrc/msm_chunked.cu", "mental_poker_tpu/ops/pallas/msm.py:133"),
    }
    extra = ("shape", "launches_b1", "launches_round", "launches_nc8", "launches_sweep", "ms_s128",
             "plain_ms_s128", "bound_ms_s128", "chain_ms", "msm_lanes_nc1_ms", "msm_lanes_nc8_ms",
             "ms_by_shape", "device_ms", "device_ms_s128", "device_ms_b128", "table_device_ms",
             "window_device_ms", "ms_b1", "launches_multigame", "launches_deck1024", "launches_parallel", "launches_bench",
             "launches_fused", "launches_fused_nc8",
             "bound_ms_model", "imads_per_add", "input_copies")
    rows = []
    for kname, (src, replaces) in meta.items():
        kv = kernels[kname]
        rows.append({
            "name": kname, "route": "cuda", "source": src, "replaces": replaces,
            "launches": kv["launches"], "max_abs_err": kv["max_abs_err"], "ms": kv["ms"],
            "plain_ms": kv["plain_ms"], "bound_ms": kv["bound_ms"], "bound_by": kv["bound_by"],
            "library_ms": None, **{k: kv[k] for k in extra if k in kv},
        })
    for kname in HASH_KERNELS:  # replace no Pallas kernel (jnp code in hash_jax.py)
        rows.append({"name": kname, "route": "cuda", "source": "mental_poker_tpu_torch/csrc/hash.cu",
                     "replaces": None, "max_abs_err": 0, **kernels[kname], **hash7[kname]})
    log(json.dumps({"prove_verify": {f"B={B}": {"ms": pv_ms, "pairs_per_s": B / pv_ms * 1e3},
                                     f"B={B}, msm_nc={NC}": {"ms": pv8_ms, "pairs_per_s": B / pv8_ms * 1e3},
                                     "B=1": {"ms": pv1_ms, "pairs_per_s": 1e3 / pv1_ms}},
                    "shuffle_argument_2x26_s": arg_s, "round_2x26_4p_4s_s": round_s,
                    "msm_s1_gather_vs_lanes_ms": engine_ms, "sweep_bls12_377_n300": sweep,
                    "multigame_64x8": {k: v for k, v in multigame.items() if k != "launches"},
                    "msm_1024": msm1024, "deck1024": {k: v for k, v in deck1024.items() if k != "launches"},
                    "parallel": {k: v for k, v in parallel.items() if k != "launches"},
                    "bench": {k: v for k, v in bench9.items() if k != "launches"},
                    "fused": {k: v for k, v in fused10.items() if not k.startswith("launches")}}))
    log(f"chip_smoke: {time.perf_counter() - started:.1f} s in all")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


# Statement counts at the lane groups' edges (the fold kernel takes four
# statements a block, the lane-MSM kernel two); 1,000 fills many blocks.
EDGE_S = (1, 2, 3, 4, 5, 31, 32, 33, 1000)


def lanes_edge_phase(dev, g) -> tuple:
    """2c, edges. `msm_lanes` (nc = 1) against its plain version, limb for
    limb, on both curves at S = 1, N = 1 and at every S of `EDGE_S` but 4 and
    5 with N = 3, points a_i * B of one base B; the first and last statements
    against host bigints, (sum_i k_i a_i) * B. Returns the Stark S = 1, N = 1
    inputs, for phase 4's times, and the shape keys (curve, S, N) compared."""
    import numpy as np
    import torch

    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
    from mental_poker_tpu_torch.ops.curve import PointP, bls12_377_g1, stark_curve
    from mental_poker_tpu_torch.ops.msm import FixedBaseTable
    from mental_poker_tpu_torch.utils.rand import GameRng

    bls = bls12_377_g1()
    bls_base = bls.host.rand_point(GameRng(9).rng)
    cases = ((stark_curve(), g.generator, g.enc.gen_table), (bls, bls_base, FixedBaseTable(bls, bls_base, 4, dev)))
    to_int = lambda v: sum(int(x) << (16 * j) for j, x in enumerate(v))
    timed, compared = [], set()
    for cv, base, table in cases:
        q = cv.host.order
        for S, N in [(1, 1)] + [(S, 3) for S in EDGE_S if S not in (4, 5)]:
            compared.add((cv.host.name, S, N))
            a = GameRng(500 + S + N).scalar_limbs(q, (S, N), cv.fr.L).astype(np.int32)
            k = GameRng(600 + S + N).scalar_limbs(q, (S, N), cv.fr.L).astype(np.int32)
            pts = table.mul(torch.as_tensor(a, device=dev))
            kk = torch.as_tensor(k, device=dev)
            got = cuda_msm.msm_lanes(cv, pts, kk)
            want = cuda_msm.msm_lanes_plain(cv, pts, kk)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            if err:
                raise AssertionError(f"msm_lanes {cv.name} [S={S}, N={N}]: kernel differs from plain by {err}")
            host = cv.to_host_points(PointP(*(t[[0, S - 1]] for t in got)))
            for h, s in zip(host, (0, S - 1)):
                total = sum(to_int(a[s, i]) * to_int(k[s, i]) for i in range(N)) % q
                require(h == cv.host.mul(total, base), ("msm_lanes edge", cv.name, S, N, s))
            log(f"msm_lanes {cv.name} [S={S}, N={N}]: equal to plain; statements 0 and {S - 1} agree with host bigints")
            if cv.name == "stark" and S == 1 and N == 1:
                timed.append(("one statement of one point", pts, kk))
    return timed, compared


def chunked_statement(dev, cv, table, S, N, seed):
    """S x N points a_i * B of a fixed base B (`table`) and S x N scalars
    k_i. At flat positions 0, 1 and 2 of the scalars stand 0, 1 and q - 1,
    and the point at flat position 3 is the identity, as far as S x N
    reaches; the last point of statement 0 is (0, 0, 0) with scalar 0 when
    N > 4, as the wide split pads a statement. Returns the points, the
    scalars and the host ints a_i (0 where the point was replaced)."""
    import numpy as np
    import torch

    from mental_poker_tpu_torch.ops.curve import map_point
    from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs

    q, Lk = cv.host.order, cv.fr.L
    kk = torch.as_tensor(GameRng(seed).scalar_limbs(q, (S, N), Lk).astype(np.int32), device=dev)
    edges = (kk.new_zeros(Lk), cv.fr.small_int_limbs(1, dev), cv.fr.tensor(ints_to_limbs([q - 1], Lk)[0], dev))
    for pos, v in enumerate(edges[:S * N]):
        kk.view(S * N, Lk)[pos] = v
    a = GameRng(seed + 1).scalar_limbs(q, (S, N), Lk).astype(np.int32)
    pts = map_point(lambda t: t.clone(), table.mul(torch.as_tensor(a, device=dev)))
    a = [[sum(int(v) << (16 * j) for j, v in enumerate(a[s, i])) for i in range(N)] for s in range(S)]
    if S * N > 3:
        for t, v in zip(pts, cv.identity((), dev)):
            t.view(S * N, -1)[3] = v
        a[3 // N][3 % N] = 0
    if N > 4:
        kk[0, N - 1] = 0
        for t in pts:
            t[0, N - 1] = 0
        a[0][N - 1] = 0
    return pts, kk, a


def chunked_check(dev, cv, base, table, S, N, nc, seed, label, host=(0, 1), verbose=True):
    """`msm_chunked` against `msm_chunked_plain` at one shape, window sums
    limb for limb, on `chunked_statement` inputs (points a_i * base from
    `table`); the folded sums of the statements `host` (negative counts from
    the end) against host bigints, (sum_i k_i a_i) * base. Returns the
    shape's key (curve, S, N, points per step) and the inputs."""
    import torch

    from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
    from mental_poker_tpu_torch.ops.curve import PointP

    P, k, a = chunked_statement(dev, cv, table, S, N, seed)
    got = cuda_msm.msm_chunked(cv, P, k, nc)
    want = cuda_msm.msm_chunked_plain(cv, P, k, nc)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"msm_chunked {label} [S={S}, N={N}, NC={nc}]: kernel differs from plain by {err}")
    rows = sorted({s % S for s in host})
    folded = cv.to_host_points(PointP(*(t[rows] for t in cuda_curve.fold_windows(cv, got, cuda_msm.WINDOW))))
    hk = k[rows].cpu().numpy()
    for h, s, ks in zip(folded, rows, hk):
        total = sum(sum(int(v) << (16 * j) for j, v in enumerate(ks[i])) * a[s][i] for i in range(N))
        require(h == cv.host.mul(total % cv.host.order, base), (label, S, N, nc, s))
    NC = cuda_msm.chunk_points(nc, N)
    if verbose:
        log(f"msm_chunked {label} [S={S}, N={N}, NC={NC}]: window sums equal to plain; "
            f"folds of statements {rows} agree with host bigints")
    return (cv.host.name, S, N, NC), (P, k)


# NC above 8: a deeper stack of partial sums (three for NC 9-16, up to five
# for NC 33-64); 52 is the JAX package's largest NC.
WIDE_NC = (9, 16, 33, 52, 64)


def chunked_edge_phase(dev, g) -> set:
    """2d, edges. `msm_chunked` against its plain version (`chunked_check`)
    at the edges of the window kernel's thread mapping (two statements to a
    block of 2 W threads, one chunk tree per thread), on both curves: every
    NC from 1 to 8 and each of `WIDE_NC` at S = 1 and 33 with N = 3 NC (no
    pad slot) and N = 2 NC - 1 (pad slots; N = 1 at NC = 1), and S = 2, 3,
    31, 32 and 1,000 at NC = 8 and 3 with N = 2 NC - 1; the first and last
    statements of each against host bigints. Returns the shape keys
    compared."""
    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
    from mental_poker_tpu_torch.ops.curve import bls12_377_g1, stark_curve
    from mental_poker_tpu_torch.ops.msm import FixedBaseTable
    from mental_poker_tpu_torch.utils.rand import GameRng

    bls = bls12_377_g1()
    bls_base = bls.host.rand_point(GameRng(9).rng)
    cases = ((stark_curve(), g.generator, g.enc.gen_table), (bls, bls_base, FixedBaseTable(bls, bls_base, 4, dev)))
    shapes = [(S, N, nc) for nc in (*range(1, 9), *WIDE_NC) for S in (1, 33) for N in (3 * nc, 2 * nc - 1)]
    shapes += [(S, 2 * nc - 1, nc) for nc in (8, 3) for S in (2, 3, 31, 32, 1000)]
    compared = set()
    for cv, base, table in cases:
        t0 = time.perf_counter()
        for i, (S, N, nc) in enumerate(shapes):
            key, _ = chunked_check(dev, cv, base, table, S, N, nc, 200 + 2 * i, f"{cv.host.name} edge",
                                   host=(0, -1), verbose=False)
            compared.add(key)
        log(f"msm_chunked {cv.host.name} edges: window sums equal to plain at {len(shapes)} shapes (NC 1-8 and "
            f"{WIDE_NC} at S = 1 and 33, N = 3 NC and 2 NC - 1; S = 2, 3, 31, 32, 1000 at NC = 8 and 3, "
            f"N = 2 NC - 1); "
            f"first and last statements agree with host bigints; {time.perf_counter() - t0:.1f} s")
    return compared


def chunked_phase(dev, g, shapes) -> tuple:
    """2d. `msm_chunked` against its plain version (`chunked_check`) at every
    shape the main path gives it at `msm_nc = 8`: 2c's five shapes after the
    wide split (`ops/msm.py::split_factor`), among them the prover diagonals
    S = 1024, N = 52 (NB = 7 steps with 4 pad slots), the combos [1024, 26],
    [896, 8], [256, 4] (NC = 4) and [256, 1] (NC = 1, no tree), and the B=1
    verifier's combos; then Stark S = 3, N = 5, NC = 4 and two BLS12-377
    shapes (S = 256, N = 10; S = 2, N = 19, which the sweep launches too;
    `sweep_phase` compares the sweep's other shapes). Returns the kernel's
    row, timed at the prover diagonals, and the set of shape keys compared."""
    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
    from mental_poker_tpu_torch.ops.curve import bls12_377_g1, stark_curve
    from mental_poker_tpu_torch.ops.msm import FixedBaseTable, split_factor
    from mental_poker_tpu_torch.utils.rand import GameRng

    stark = stark_curve()
    bls = bls12_377_g1()
    bls_base = bls.host.rand_point(GameRng(9).rng)
    bls_table = FixedBaseTable(bls, bls_base, 4, dev)
    cases = []
    for name, S0, N0 in shapes:
        F = split_factor(S0, N0, NC)
        cases.append((f"Stark {name} at nc = {NC}", stark, g.generator, g.enc.gen_table, S0 * F, -(-N0 // F), NC))
    cases += [("Stark", stark, g.generator, g.enc.gen_table, 3, 5, 4),
              ("BLS12-377", bls, bls_base, bls_table, 256, 10, NC),
              ("BLS12-377", bls, bls_base, bls_table, 2, 19, NC)]
    compared, diagonals, b1 = set(), None, []
    for i, (label, cv, base, table, S, N, nc) in enumerate(cases):
        key, inputs = chunked_check(dev, cv, base, table, S, N, nc, 31 + 2 * i, label)
        compared.add(key)
        if label.startswith("Stark prover"):
            diagonals = (cv, *inputs, nc)
        elif "at B=1" in label:
            b1.append((cv, *inputs, nc))

    cv, P, k, nc = diagonals
    S, N = k.shape[0], k.shape[1]
    L, Lk = cv.fq.L, cv.fr.L
    W = cuda_msm.num_windows(cv)
    NB = -(-N // nc)
    ms = cuda_ms(lambda: cuda_msm.msm_chunked(cv, P, k, nc), 10, 2)
    split = kernel_ms_by(lambda: cuda_msm.msm_chunked(cv, P, k, nc), CHUNKED_SPLIT)
    dms = sum(split.values())
    plain = cuda_ms(lambda: cuda_msm.msm_chunked_plain(cv, P, k, nc), 1, 0)
    lanes1 = cuda_ms(lambda: cuda_msm.msm_lanes(cv, P, k, nc=1), 10, 2)
    lanes8 = cuda_ms(lambda: cuda_msm.msm_lanes(cv, P, k, nc=nc), 10, 2)
    # the additions the function needs: the multiples tables (14 per point),
    # then one per point and window into the window sums; the pad slots'
    # additions are the schedule's, not the function's
    adds = S * N * ((1 << cuda_msm.WINDOW) - 2) + S * W * N
    bms, by = bound(adds * ADD_PRODUCTS * word_products(L) * 2, (S * N * (3 * L + Lk) + W * S * 3 * L) * 4)
    # the dependent chain of one window: its point's table (one thread of
    # the table kernel), then NB chunks of NC additions (NC - 1 in the tree
    # and the accumulate) in the window kernel's thread
    chain_adds = (1 << cuda_msm.WINDOW) - 2 + NB * nc
    chain_ms = chain_adds * ADD_PRODUCTS * word_products(L) * 2 / SM_CLOCK_HZ * 1e3
    log(f"msm_chunked [S={S}, N={N}, NC={nc}]: {ms:.3f} ms (device {dms:.4f} ms: table kernel "
        f"{split['table']:.4f} ms, window kernel {split['window']:.4f} ms), plain {plain:.1f} ms, bound {bms:.4f} ms ({by}; "
        f"{S * N * ((1 << cuda_msm.WINDOW) - 2)} table and {S * W * N} window additions); "
        f"one window's chain of {chain_adds} additions at one IMAD per clock: {chain_ms:.4f} ms; "
        f"msm_lanes at nc = 1 {lanes1:.3f} ms, at nc = {nc} (chunked + fold) {lanes8:.3f} ms")
    # the B=1 verifier's shapes at nc = 8: a window's chain is one chunk of
    # at most 8 additions after the table's 14
    by_b1 = {}
    for cv1, P1, k1, nc1 in b1:
        S1, N1 = k1.shape[0], k1.shape[1]
        ms1 = cuda_ms(lambda: cuda_msm.msm_chunked(cv1, P1, k1, nc1), 10, 2)
        split1 = kernel_ms_by(lambda: cuda_msm.msm_chunked(cv1, P1, k1, nc1), CHUNKED_SPLIT)
        NC1 = cuda_msm.chunk_points(nc1, N1)
        by_b1[f"S={S1}, N={N1}, NC={NC1}"] = dict(ms=ms1, **{f"{k_}_device_ms": v for k_, v in split1.items()})
        log(f"msm_chunked B=1 verifier [S={S1}, N={N1}, NC={NC1}]: {ms1:.3f} ms (device: table kernel "
            f"{split1['table']:.4f} ms, window kernel {split1['window']:.4f} ms)")
    row = dict(max_abs_err=0.0, ms=ms, device_ms=dms, table_device_ms=split["table"],
               window_device_ms=split["window"], plain_ms=plain, bound_ms=bms, bound_by=by, chain_ms=chain_ms,
               msm_lanes_nc1_ms=lanes1, msm_lanes_nc8_ms=lanes8, ms_b1=by_b1,
               shape=f"Stark prover diagonals: S={S}, N={N}, NC={nc}")
    return row, compared


@contextlib.contextmanager
def chunked_shapes(seen: set):
    """Record in `seen` the shape key (curve, S, N, points per step) of every
    chunked-kernel launch made inside the block."""
    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm

    launch = cuda_msm.msm_chunked_cuda

    def recording(cv, P, k, nc):
        seen.add((cv.host.name, k.shape[0], k.shape[1], cuda_msm.chunk_points(nc, k.shape[1])))
        return launch(cv, P, k, nc)

    cuda_msm.msm_chunked_cuda = recording
    try:
        yield seen
    finally:
        cuda_msm.msm_chunked_cuda = launch


def sweep_phase(dev, compared: set):
    """6. The reference's parameter sweep (`run_sweep`: N = 300 cards at the
    five (m, n) splits of `REFERENCE_SWEEP`, BLS12-377 G1, seed 0) with
    `msm_nc = 8`: each point proved and verified (`benchmark_parameters`
    raises on a rejected proof), launch counts read around each point. Then
    the chunked kernel against its plain version (`chunked_check`, the first
    statement against host bigints) at every shape the sweep launched it at
    that phase 2d did not compare. Returns (rows, chunked-kernel launches
    over the sweep)."""
    import torch

    from mental_poker_tpu_torch import config
    from mental_poker_tpu_torch.models import parameter_selection as ps
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.ops.curve import bls12_377_g1
    from mental_poker_tpu_torch.ops.msm import FixedBaseTable
    from mental_poker_tpu_torch.utils.rand import GameRng

    rows, seen = [], set()
    with config.override(msm_nc=NC), chunked_shapes(seen):
        for m, n in ps.REFERENCE_SWEEP:
            torch.cuda.synchronize()
            cuda_ops.reset_launches()
            t0 = time.perf_counter()
            (row,) = ps.run_sweep([(m, n)], device=dev, verbose=False)
            row["point_s"] = time.perf_counter() - t0
            row["launches"] = dict(cuda_ops.LAUNCHES)
            log(f"sweep BLS12-377 (m, n) = ({m}, {n}), N = {m * n}: prove {row['prove_s']:.3f} s, "
                f"verify {row['verify_s']:.3f} s, {row['proof_bytes']} proof bytes, point {row['point_s']:.2f} s "
                f"(setup and keys included); verified; launches {row['launches']}")
            for k in CHUNKED_KERNELS:
                if row["launches"][k] <= 0:
                    raise AssertionError(f"the sweep point ({m}, {n}) did not launch kernel {k}")
            if row["launches"]["msm_lanes"]:
                raise AssertionError(f"the sweep point ({m}, {n}) launched the nc = 1 MSM kernel at msm_nc = {NC}")
            rows.append(row)
    bls = bls12_377_g1()
    base = bls.host.rand_point(GameRng(9).rng)
    table = FixedBaseTable(bls, base, 4, dev)
    log(f"sweep: the chunked kernel ran at {len(seen)} shapes, {len(seen - compared)} not compared in phase 2d")
    for i, (curve, S, N, nc) in enumerate(sorted(seen - compared)):
        require(curve == bls.host.name, curve)
        chunked_check(dev, bls, base, table, S, N, nc, 101 + 2 * i, "BLS12-377 sweep", host=(0,))
    return rows, sum(r["launches"]["msm_chunked"] for r in rows)


def fold_phase(dev, g, kernels, batches=tuple(sorted(EDGE_S + (BATCH,)))) -> dict:
    """5a. `fold_windows` against its plain version, limb for limb, at the
    built-in W of each curve (Stark 63, BLS12-377 64) and S statements in
    `batches` (the lane groups' edges, S = 128 and S = 1,000). The window
    sums are k[w, s] * B for a fixed base B (one window sum the identity), so
    the host check of the first and last statements is
    (sum_w 2^(4w) k[w, s]) * B (`fold_check`). Returns the kernel's row:
    times at S = 1 and S = 128 on Stark (the host argument's combos give
    S = 1), its bound, and the chain bound."""
    from mental_poker_tpu_torch import profiling
    from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
    from mental_poker_tpu_torch.ops.curve import bls12_377_g1, stark_curve
    from mental_poker_tpu_torch.ops.msm import FixedBaseTable
    from mental_poker_tpu_torch.utils.rand import GameRng

    c = cuda_curve.FOLD_WINDOW
    row = {"max_abs_err": 0.0}
    bls = bls12_377_g1()
    bls_base = bls.host.rand_point(GameRng(8).rng)
    cases = ((stark_curve(), g.generator, g.enc.gen_table), (bls, bls_base, FixedBaseTable(bls, bls_base, c, dev)))
    for cv, base, table in cases:
        L, q = cv.fq.L, cv.host.order
        W = cuda_curve.FOLD_W[L]
        for S in batches:
            sums, err = fold_check(dev, cv, base, table, S)
            row["max_abs_err"] = max(row["max_abs_err"], err)
            if cv.name != "stark" or S not in (1, BATCH):
                continue
            ms = cuda_ms(lambda: cuda_curve.fold_windows(cv, sums, c), 20, 2)
            dms = kernel_ms(lambda: cuda_curve.fold_windows(cv, sums, c), profiling.KERNEL_FUNCTIONS["fold_windows"])
            plain = cuda_ms(lambda: cuda_curve.fold_windows_plain(cv, sums, c), 2, 1)
            bms, by = bound(S * (W * ADD_PRODUCTS + c * W * DBL_PRODUCTS) * word_products(L) * 2,
                            (S * W + S) * 3 * L * 4)
            # the critical path: W * (c + 1) dependent point operations (252
            # doublings and 63 additions on Stark), each GROUP_CHAIN_PRODUCTS
            # Montgomery products long on a lane group, each product's word
            # products at two IMADs, issued at one IMAD per clock
            chain_imads = W * (c + 1) * GROUP_CHAIN_PRODUCTS * word_products(L) * 2
            chain_ms = chain_imads / SM_CLOCK_HZ * 1e3
            log(f"fold_windows stark [W={W}, S={S}]: {ms:.4f} ms (device {dms:.4f} ms), plain {plain:.1f} ms, bound {bms:.5f} ms ({by}); "
                f"the critical path of {W * (c + 1)} point operations at {GROUP_CHAIN_PRODUCTS} products each, "
                f"one IMAD per clock: {chain_ms:.4f} ms")
            if S == 1:
                row.update(ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms, bound_by=by, chain_ms=chain_ms,
                           shape=f"Stark W={W}, S=1 (the host argument's combos)")
            else:
                row.update(ms_s128=ms, device_ms_s128=dms, plain_ms_s128=plain, bound_ms_s128=bms)
    return row


def fold_check(dev, cv, base, table, S) -> tuple:
    """`fold_windows` against its plain version at the curve's built-in W and
    S statements, limb for limb; the window sums are k[w, s] * base from
    `table` (the top window of statement 0 the identity), and statements 0
    and S - 1 are checked against host bigints,
    (sum_w 2^(4w) k[w, s]) * base. Returns the window sums and the error."""
    import numpy as np
    import torch

    from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
    from mental_poker_tpu_torch.ops.curve import PointP
    from mental_poker_tpu_torch.utils.rand import GameRng

    c = cuda_curve.FOLD_WINDOW
    L, q = cv.fq.L, cv.host.order
    W = cuda_curve.FOLD_W[L]
    kh = GameRng(W + S).scalar_limbs(q, (W, S), cv.fr.L).astype(np.int32)
    kh[W - 1, 0] = 0  # the top window's sum of statement 0 is the identity
    sums = table.mul(torch.as_tensor(kh, device=dev))  # [W, S] projective points
    got = cuda_curve.fold_windows(cv, sums, c)
    want = cuda_curve.fold_windows_plain(cv, sums, c)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"fold_windows {cv.name} W={W} S={S}: kernel differs from plain by {err}")
    host = cv.to_host_points(PointP(*(t[[0, S - 1]] for t in got)))
    for h, s in zip(host, (0, S - 1)):
        total = sum(sum(int(v) << (16 * j) for j, v in enumerate(kh[w, s])) << (c * w) for w in range(W))
        require(h == cv.host.mul(total % q, base), (cv.name, W, S, s))
    log(f"fold_windows {cv.name} [W={W}, S={S}]: equal to plain; statements 0 and {S - 1} agree with host bigints")
    return sums, err


def gather_phase(dev, g, sizes=tuple(range(1, 16)) + (26, 52)) -> dict:
    """5b. The gather engine against the lane engine at one statement of N
    points: equal affine points, and the host sum (points a_i * G, so the
    sum is (sum_i k_i a_i) * G). Times both engines for every N below 16,
    where the JAX rule (`ops/msm.py::use_lanes`) takes the gather engine;
    returns {N: [gather ms, lanes ms]}."""
    import numpy as np
    import torch

    from mental_poker_tpu_torch.ops import msm as msm_mod
    from mental_poker_tpu_torch.ops.curve import stark_curve
    from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs

    cv = stark_curve()
    q = cv.host.order
    out = {}
    for N in sizes:
        r = GameRng(300 + N)
        a = r.scalar_limbs(q, (N,), cv.fr.L).astype(np.int32)
        k = r.scalar_limbs(q, (N,), cv.fr.L).astype(np.int32)
        k[0] = 0
        if N > 1:
            a[1] = 0  # an identity point
        if N > 2:
            k[2] = 0
            k[2, 0] = 1
        if N > 3:
            k[N - 1] = ints_to_limbs([q - 1], cv.fr.L)[0]
        pts = g.enc.gen_table.mul(torch.as_tensor(a, device=dev))
        kt = torch.as_tensor(k, device=dev)
        gathered = msm_mod.msm(cv, pts, kt, engine="gather")
        lanes = msm_mod.msm(cv, pts, kt, engine="lanes")
        to_int = lambda v: sum(int(x) << (16 * j) for j, x in enumerate(v))
        total = sum(to_int(ai) * to_int(ki) for ai, ki in zip(a, k)) % q
        want = [cv.host.mul(total, g.generator)]
        require(cv.to_host_points(gathered) == cv.to_host_points(lanes) == want, ("gather vs lanes", N))
        if N < 16:
            gms = cuda_ms(lambda: msm_mod.msm(cv, pts, kt, engine="gather"), 10, 2)
            lms = cuda_ms(lambda: msm_mod.msm(cv, pts, kt, engine="lanes"), 10, 2)
            out[N] = [gms, lms]
            log(f"msm S=1 N={N}: gather engine equals lane engine; host bigints agree; "
                f"gather {gms:.3f} ms, lanes {lms:.3f} ms")
        else:
            log(f"msm S=1 N={N}: gather engine equals lane engine; host bigints agree")
    wins = [N for N, (gms, lms) in out.items() if gms < lms]
    log(f"msm S=1, N < 16: the gather engine is the faster at N = {wins or 'none'}")
    return out


def argument_phase(dev, m=2, n=26):
    """5c. The host Bayer-Groth `ShuffleArgument` on a 52-card deck at
    (m, n) with a statement from the port's `DLCards`: prove, verify (launch
    counts read around both), the staged verifier on the host proof, the
    host verifier on a staged proof (`shuffle_and_remask`, through
    `dev_proof_to_host`), and a substituted deck. Returns (seconds,
    launches)."""
    import torch

    from mental_poker_tpu_torch.crypto import elgamal, proof_io
    from mental_poker_tpu_torch.crypto.errors import HADAMARD, ProofVerificationError
    from mental_poker_tpu_torch.crypto.transcript import SHUFFLE_RNG_SEED, TranscriptBatch
    from mental_poker_tpu_torch.models.round import cipher_take
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.protocol import api
    from mental_poker_tpu_torch.protocol.dl_cards import DLCards
    from mental_poker_tpu_torch.utils.rand import GameRng

    proto = DLCards(device=dev)
    cv = proto.cv
    rng = GameRng(2026)
    N = m * n
    pp = proto.setup(rng, m, n)
    pk, sk = proto.player_keygen(rng, pp)
    agg = proto.compute_aggregate_key(pp, [(pk, proto.prove_key_ownership(rng, pp, pk, sk, b"smoke"), b"smoke")])
    deck = elgamal.rand_ciphertexts(cv, rng, N, dev)
    pi = rng.permutation(N)
    rho = [rng.scalar(cv.host.order) for _ in range(N)]
    shuffled = proto.remask_cards(pp, agg, cipher_take(deck, list(pi)), rho)
    arg = api.ShuffleArgument()
    ts = lambda: TranscriptBatch.fixed(SHUFFLE_RNG_SEED, 1)
    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    proof = arg.prove((pp, agg), (deck, shuffled), (pi, rho), ts(), rng)
    t1 = time.perf_counter()
    arg.verify((pp, agg), (deck, shuffled), proof, ts())
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(cuda_ops.LAUNCHES)
    log(f"ShuffleArgument ({m}, {n}): prove {t1 - t0:.2f} s, verify {t2 - t1:.2f} s, "
        f"{proof_io.shuffle_proof_size(proof, cv.host)} proof bytes; launches {launches}")
    # Its scalar algebra is host ints and its points reach the host without a
    # field product, so it runs no mont_mul; at (2, 26) its 26- and 52-point
    # MSMs take the lane kernel, its combos the gather engine and the fold.
    for k in ("point_add", "msm_lanes", "fold_windows"):
        if launches[k] <= 0:
            raise AssertionError(f"the host argument did not launch kernel {k}")
    proto.verify_shuffle(pp, agg, deck, shuffled, proof)
    log("the staged verifier accepts the host proof (host_proof_to_dev)")
    shuffled2, staged_proof = proto.shuffle_and_remask(rng, pp, agg, deck, rho, pi)
    arg.verify((pp, agg), (deck, shuffled2), staged_proof, ts())
    log("the host verifier accepts a staged proof (dev_proof_to_host)")
    bogus = elgamal.rand_ciphertexts(cv, GameRng(123), N, dev)
    try:
        arg.verify((pp, agg), (deck, bogus), proof, ts())
    except ProofVerificationError as e:
        if e.name != HADAMARD:
            raise AssertionError(f"a substituted deck failed with {e.name!r}, expected {HADAMARD!r}") from e
        log(f"substituted deck rejected by the host verifier: {e}")
    else:
        raise AssertionError("the host verifier accepted a substituted deck")
    return t2 - t0, launches


def round_phase(dev, n=26, num_shuffles=4):
    """5d. `play_round(seed=7, m=2, n, 4 players, num_shuffles)`, the
    reference's round.rs shape at n = 26: four distinct cards, each peek
    equal to its open (play_round raises otherwise). Returns (seconds,
    launches, the opened cards)."""
    import torch

    from mental_poker_tpu_torch.models.round import play_round
    from mental_poker_tpu_torch.ops import cuda as cuda_ops

    torch.cuda.synchronize()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    opened = play_round(seed=7, m=2, n=n, num_shuffles=num_shuffles, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    require(len(opened) == 4 and len(set(opened.values())) == 4, opened)
    log(f"round (2, {n}), 4 players, {num_shuffles} shuffles: {secs:.2f} s; opened {opened}; launches {launches}")
    for k in STAGED_KERNELS:  # the round's shuffles are staged proofs: no gather MSM
        if launches[k] <= 0:
            raise AssertionError(f"the round did not launch kernel {k}")
    return secs, launches, opened


@contextlib.contextmanager
def elementwise_lanes(seen: set):
    """Record in `seen` a key (kernel, field or curve, lanes) for every
    launch of the `mont_mul` and `point_add` kernels made inside the block
    (a call on empty tensors launches nothing and is not recorded)."""
    from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
    from mental_poker_tpu_torch.ops.cuda import field as cuda_field

    mont_mul, point_add = cuda_field.mont_mul_cuda, cuda_curve.point_add_cuda

    def mont_mul_recording(fld, a, b):
        if a.numel():
            seen.add(("mont_mul", fld.name, a.numel() // fld.L))
        return mont_mul(fld, a, b)

    def point_add_recording(cv, P, Q):
        if P[0].numel():
            seen.add(("point_add", cv.host.name, P[0].numel() // P[0].shape[-1]))
        return point_add(cv, P, Q)

    cuda_field.mont_mul_cuda, cuda_curve.point_add_cuda = mont_mul_recording, point_add_recording
    try:
        yield seen
    finally:
        cuda_field.mont_mul_cuda, cuda_curve.point_add_cuda = mont_mul, point_add


def elementwise_check(dev, g, key, seed) -> None:
    """`mont_mul` or `point_add` (by `key`, as `elementwise_lanes` records
    it) against its plain version at that many lanes on the card, limb for
    limb. mont_mul: uniform reduced operands with 0, 1 and p - 1 at the
    front. point_add: points k G of the Stark generator's table with
    identity + P, P + (-P) and P + P at the front."""
    import numpy as np
    import torch

    from mental_poker_tpu_torch.ops import field as field_mod
    from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
    from mental_poker_tpu_torch.ops.cuda import field as cuda_field
    from mental_poker_tpu_torch.ops.curve import PointP
    from mental_poker_tpu_torch.utils.rand import GameRng

    kernel, name, n = key
    npr = np.random.default_rng(seed)
    if kernel == "mont_mul":
        fields = {f.name: f for f in (field_mod.stark_fq(), field_mod.stark_fr(), field_mod.bls12_377_fq())}
        f = fields[name]
        ops = []
        for _ in range(2):
            vals = ([0, 1, f.p - 1] + [int.from_bytes(npr.bytes(48), "little") % f.p for _ in range(n)])[:n]
            ops.append(f.tensor(f.from_int_array(vals), dev))
        got, want = [cuda_field.mont_mul(f, *ops)], [cuda_field.mont_mul_plain(f, *ops)]
    else:
        cv = g.cv
        require(name == cv.host.name, key)
        q = cv.host.order
        k1, k2 = (torch.as_tensor(GameRng(seed + i).scalar_limbs(q, (n,), cv.fr.L).astype(np.int32), device=dev)
                  for i in range(2))
        P, Q = g.enc.gen_table.mul(k1), g.enc.gen_table.mul(k2)
        idx = torch.arange(n, device=dev)[:, None]
        edges = ((0, cv.identity((n,), dev), Q), (1, cv.neg(P), P), (2, P, P))  # (lane, left, right)
        for i, A, B_ in edges[:n]:
            P = PointP(*(torch.where(idx == i, a, x) for a, x in zip(A, P)))
            Q = PointP(*(torch.where(idx == i, b, y) for b, y in zip(B_, Q)))
        got, want = cuda_curve.point_add(cv, P, Q), cuda_curve.point_add_plain(cv, P, Q)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{kernel} {name} at {n} lanes: kernel differs from plain by {err}")


def multigame_phase(dev, g, elementwise_compared: set, profile_dir=None, G=64, P=8, m=2, n=26) -> dict:
    """7a. The bench's multigame flow at full width (`bench.multigame_flow`:
    G games of P players at (m, n), M = G P m n reveal statements): one warm
    flow; one flow with launch counts and peak device memory read around it,
    whose four checks must hold in every lane and which must launch
    `point_add` and `mont_mul` and no MSM kernel, and both kernels against
    their plain versions (`elementwise_check`) at every lane count that
    flow launched them at and `elementwise_compared` does not hold; one
    reveal response s ^ 1, which `cp_verify_dev` must reject in that lane
    alone; games per second as the median of three timed flows; with
    `profile_dir`, one more flow traced by torch.profiler, its device time
    by kernel, its device busy time and its idle share against the median
    flow. Then the flow at G = 2, P = 3, (2, 2) on the card and on the CPU
    (the plain versions): every proof tensor equal, limb for limb."""
    import torch

    from mental_poker_tpu_torch import bench
    from mental_poker_tpu_torch.crypto import sigma_device, transcript_dev
    from mental_poker_tpu_torch.crypto.transcript import REVEAL_RNG_SEED
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.parallel.sharding import leaves

    t0 = time.perf_counter()
    mg = bench.multigame_setup(G, P, m, n, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    bench.multigame_flow(mg)
    torch.cuda.synchronize()
    lanes = set()
    cuda_ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hashed = set()
    with elementwise_lanes(lanes), hash_shapes(hashed):
        out = bench.multigame_flow(mg)
        torch.cuda.synchronize()
    counted_s = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ok = [bool(c.all()) for c in out.checks]
    M = out.checks[2].shape[0]
    log(f"multigame G={G}, P={P}, ({m}, {n}), M={M} reveal statements: checks (mask, remask, reveal, unmask) {ok}; "
        f"one flow {counted_s:.3f} s; launches {launches}; peak device memory {peak} bytes; set-up {setup_s:.2f} s")
    require(all(ok), "a multigame check failed")
    for k in ("point_add", "mont_mul"):
        require(launches[k] > 0, f"the multigame flow did not launch {k}")
    for k in ("msm_lanes", "msm_chunked", "fold_windows"):
        require(launches[k] == 0, f"the multigame flow launched the MSM kernel {k}")
    new = sorted(lanes - elementwise_compared)
    t0 = time.perf_counter()
    for i, key in enumerate(new):
        elementwise_check(dev, g, key, 601 + 2 * i)
    log(f"multigame: mont_mul and point_add equal to plain at every new lane count of the flow "
        f"({len(new)} of {len(lanes)}: {new}; {time.perf_counter() - t0:.1f} s)")

    lane = M // 3 + 1
    prf3 = out.proofs[2]
    s = prf3.s.clone()
    s[lane, 0] ^= 1
    cv = mg.cv
    bad = sigma_device.cp_verify_dev(cv, transcript_dev.init(REVEAL_RNG_SEED, (M,), dev), *out.reveal,
                                     prf3._replace(s=s))
    rejected = (~bad).nonzero().flatten().tolist()
    require(rejected == [lane], f"the tampered reveal response was rejected in lanes {rejected[:8]}, not [{lane}]")
    log(f"multigame: reveal response s ^ 1 in lane {lane} of {M} rejected in that lane alone")

    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        res = bench.multigame_flow(mg)
        require(all(bool(c.all()) for c in res.checks), "a multigame check failed")
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
    med = sorted(runs)[1]
    log(f"multigame: {G / med:.3f} games/s (median of runs {[round(r, 3) for r in runs]} s)")
    trace = {}
    if profile_dir:
        from mental_poker_tpu_torch import profiling

        tr = profiling.trace(lambda: bench.multigame_flow(mg), profile_dir, "multigame", dev)
        by_kernel, traced_s = tr["kernel_device_ms"], tr["wall_s"]
        busy_s = tr["device_busy_ms"] / 1e3
        trace = dict(device_ms_by_kernel=by_kernel, device_launches=tr["device_launches"], traced_flow_s=traced_s,
                     idle_share_of_median=1 - busy_s / med, idle_share_of_traced=tr["idle_share_of_traced"],
                     top_device_ops=tr["top_ops"])
        log(f"multigame trace ({tr['trace']}): device busy {tr['device_busy_ms']:.3f} ms ({tr['device_launches']} "
            f"device launches) in a {traced_s:.3f} s traced flow; idle {trace['idle_share_of_median']:.4f} of the "
            f"median flow, {trace['idle_share_of_traced']:.4f} of the traced one; by kernel (ms): {by_kernel}; "
            f"top device operations: {tr['top_ops']}")

    small = []
    before = torch.get_num_threads()
    for d in (dev, torch.device("cpu")):
        torch.set_num_threads(1 if d.type == "cpu" else before)
        with torch.inference_mode():
            res = bench.multigame_flow(bench.multigame_setup(2, 3, 2, 2, d))
        require(all(bool(c.all()) for c in res.checks), f"a small multigame check failed on {d}")
        small.append([t.cpu() for t in leaves(res.proofs)])
    torch.set_num_threads(before)
    diff = [i for i, (a, b) in enumerate(zip(*small)) if not torch.equal(a, b)]
    require(not diff and len(small[0]) == 21, f"the card's small multigame proofs differ from the CPU's at {diff}")
    log(f"multigame G=2, P=3, (2, 2): the card's proofs equal the CPU plain versions' ({len(small[0])} tensors)")
    return dict(games_per_s=G / med, runs_s=runs, counted_flow_s=counted_s, peak_memory_bytes=peak,
                reveal_statements=M, elementwise_lanes=sorted(lanes), launches=launches, hash_shapes=sorted(hashed),
                **trace)


# Phase 7b: the lanes of every transcript-kernel launch scale with the batch
# (one lane a deck, card, Merkle node or statement), so the recorded flows'
# shapes give the benchmark cells' shapes: phase 3's staged B = 1 prove+verify
# is `shuffle52.table`'s fused B = 1 one with every draw one round of
# `FUSED_CANDIDATES` (phase 10 requires its capture to launch exactly these),
# and `shuffle52.batch` (fused B = 1,024) at 1,024 times the lanes; phase 7a's
# G = 64 games are `game8p.batch` at G = 2,048 (32 times the lanes).
HASH_CELLS = {"shuffle52.table": ("b1", 1), "shuffle52.batch": ("b1", 1024), "game8p.batch": ("game", 32)}


@contextlib.contextmanager
def hash_shapes(seen: set):
    """Record in `seen` a key for every launch of the transcript kernels
    made inside the block: ("blake2s", lanes, message bytes, with the seed
    suffix, bytes out) and ("chacha_draw", lanes, field, K)."""
    from mental_poker_tpu_torch.ops import field as field_mod
    from mental_poker_tpu_torch.ops.cuda import hash as cuda_hash

    names = {f.p: f.name for f in (field_mod.stark_fr(), field_mod.bls12_377_fr(), field_mod.bls12_377_fq())}
    blake2s, chacha_draw = cuda_hash.blake2s, cuda_hash.chacha_draw

    def blake2s_recording(data_u8, suffix_words=None, out_bytes=False):
        out = blake2s(data_u8, suffix_words, out_bytes)
        if out.numel():
            seen.add(("blake2s", out.numel() // out.shape[-1], data_u8.shape[-1], suffix_words is not None, out_bytes))
        return out

    def chacha_draw_recording(seed, widx, p, nw, hi_mask, K):
        if widx.numel():
            seen.add(("chacha_draw", widx.numel(), names[p], K))
        return chacha_draw(seed, widx, p, nw, hi_mask, K)

    cuda_hash.blake2s, cuda_hash.chacha_draw = blake2s_recording, chacha_draw_recording
    try:
        yield seen
    finally:
        cuda_hash.blake2s, cuda_hash.chacha_draw = blake2s, chacha_draw


def hash_check(dev, key, seed: int) -> None:
    """The transcript kernel of `key` (`hash_shapes`) against its plain
    version on the card at that shape, bit for bit: uniform message bytes
    and seed words; for a draw, uniform keys and start words below 4,096."""
    import numpy as np
    import torch

    from mental_poker_tpu_torch.crypto import hash_dev, transcript_dev
    from mental_poker_tpu_torch.ops import field as field_mod
    from mental_poker_tpu_torch.ops.cuda import hash as cuda_hash

    npr = np.random.default_rng(seed)
    kind, lanes = key[:2]
    words = lambda shape: torch.as_tensor(npr.integers(0, 2**32, size=shape, dtype=np.int64), device=dev)
    if kind == "blake2s":
        _, _, n, suffix, out_bytes = key
        data = torch.as_tensor(npr.integers(0, 256, size=(lanes, n), dtype=np.uint8), device=dev)
        sfx = words((lanes, 8)) if suffix else None
        want = hash_dev.blake2s_plain(data, sfx)
        got = [cuda_hash.blake2s(data, sfx, out_bytes)]
        want = [hash_dev.words_to_bytes(want) if out_bytes else want]
    else:
        _, _, fname, K = key
        fld = getattr(field_mod, fname)()
        keys, widx = words((lanes, 8)), torch.as_tensor(npr.integers(0, 4096, size=lanes), device=dev)
        got = transcript_dev._draw(keys, widx, fld, K)
        want = transcript_dev._draw_plain(keys, widx, fld, K)
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(got, want)), f"{key}: the kernel differs from its plain version")


def hash_phase(dev, seen: dict) -> dict:
    """7b. The transcript kernels (`csrc/hash.cu`) against their plain
    versions (`hash_check`) at every shape the flows launched them at
    (`seen`, by flow: phase 3's staged B = 128 ("staged") and B = 1 ("b1"),
    phase 7a's multigame ("game")) and at the benchmark cells' shapes
    (`HASH_CELLS`, each cell's printed). Returns, by kernel, the number of
    shapes compared, and `table_shapes`: the keys of `shuffle52.table` (a
    fused B = 1 prove+verify)."""
    from mental_poker_tpu_torch.crypto.transcript_dev import FUSED_CANDIDATES

    t0 = time.perf_counter()
    fused = lambda key: key[:3] + (FUSED_CANDIDATES,) if key[0] == "chacha_draw" else key
    cells = {}
    for cell, (flow, scale) in HASH_CELLS.items():
        cells[cell] = sorted((k[0], k[1] * scale) + k[2:] for k in map(fused if flow == "b1" else tuple, seen[flow]))
        log(f"hash {cell}: {cells[cell]}")
    todo = sorted(set().union(*seen.values(), *cells.values()), key=lambda k: k[:2])
    for i, key in enumerate(todo):
        hash_check(dev, key, 1301 + i)
    out = {k: dict(shapes_compared=sum(key[0] == k for key in todo)) for k in HASH_KERNELS}
    log(f"hash: both kernels equal to plain at {len(todo)} shapes "
        f"({ {k: v['shapes_compared'] for k, v in out.items()} }; {time.perf_counter() - t0:.1f} s)")
    out["table_shapes"] = set(cells["shuffle52.table"])
    return out


def msm1024_phase(dev, npts=1024) -> dict:
    """7b. The bench's msm mode once (`bench.msm_setup`: 1,024 Stark points
    from `GameRng(7)`): the sum equals the host bigints' sum of k_i P_i;
    then timed (CUDA events, median of five)."""
    from mental_poker_tpu_torch import bench
    from mental_poker_tpu_torch.ops import msm as msm_mod
    from mental_poker_tpu_torch.ops.curve import PointP
    from mental_poker_tpu_torch.utils.rand import limbs_to_int

    cv, pts, k = bench.msm_setup(npts, dev)
    out = msm_mod.msm(cv, pts, k)
    host = cv.host
    acc = host.identity
    for p, kk in zip(cv.to_host_points(pts), k.cpu().numpy()):
        acc = host.add(acc, host.mul(limbs_to_int(kk), p))
    require(cv.to_host_points(PointP(*(t[None] for t in out))) == [acc], "msm_1024 differs from the host sum")
    ms = cuda_ms(lambda: msm_mod.msm(cv, pts, k), 5, 1)
    log(f"msm of {npts} points: equal to the host bigints' sum; {ms:.3f} ms, {npts / ms * 1e3:.0f} points/s")
    return dict(ms=ms, points_per_s=npts / ms * 1e3)


@contextlib.contextmanager
def lanes_shapes(seen: set):
    """Record in `seen` the shape key (curve, S, N) of every launch of the
    per-statement MSM kernel made inside the block."""
    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm

    launch = cuda_msm.msm_lanes_cuda

    def recording(cv, P, k):
        seen.add((cv.host.name, k.shape[0], k.shape[1]))
        return launch(cv, P, k)

    cuda_msm.msm_lanes_cuda = recording
    try:
        yield seen
    finally:
        cuda_msm.msm_lanes_cuda = launch


def lanes_check(dev, cv, base, table, S, N, seed, label):
    """`msm_lanes` (nc = 1) against `msm_lanes_plain` at one shape, limb for
    limb, on `chunked_statement` inputs; statements 0 and S - 1 against host
    bigints, (sum_i k_i a_i) * base."""
    import torch

    from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
    from mental_poker_tpu_torch.ops.curve import PointP

    P, k, a = chunked_statement(dev, cv, table, S, N, seed)
    got = cuda_msm.msm_lanes(cv, P, k, nc=1)
    want = cuda_msm.msm_lanes_plain(cv, P, k)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"msm_lanes {label} [S={S}, N={N}]: kernel differs from plain by {err}")
    rows = sorted({0, S - 1})
    hk = k[rows].cpu().numpy()
    for h, s, ks in zip(cv.to_host_points(PointP(*(t[rows] for t in got))), rows, hk):
        total = sum(sum(int(v) << (16 * j) for j, v in enumerate(ks[i])) * a[s][i] for i in range(N))
        require(h == cv.host.mul(total % cv.host.order, base), (label, S, N, s))
    log(f"msm_lanes {label} [S={S}, N={N}]: equal to plain; statements {rows} agree with host bigints")


def deck1024_phase(dev, g, lanes_compared: set, m=16, n=64) -> dict:
    """7c. The bench's deck1024 mode once (`bench.shuffle_setup`: one
    1,024-card deck at (16, 64), B = 1, `GameRng(99)`, window-8 tables):
    prove and verify with launch counts read around them and every shape of
    the per-statement MSM kernel recorded; a deck with two output cards
    swapped fails with "Hadamard Product (5.1)"; then the kernel against
    its plain version (`lanes_check`) at every recorded shape phase 2c did
    not compare."""
    import torch

    from mental_poker_tpu_torch import bench, config
    from mental_poker_tpu_torch.arguments import device_api
    from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
    from mental_poker_tpu_torch.crypto.errors import HADAMARD, ProofVerificationError
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.ops.curve import map_point

    t0 = time.perf_counter()
    with config.override(fixed_window_bits=WINDOW):
        sb = bench.shuffle_setup(m, n, 1, 99, b"b", dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    seen = set()
    cuda_ops.reset_launches()
    t0 = time.perf_counter()
    with lanes_shapes(seen):
        proof, checks = sb.prove_verify()
        ok = [bool(c.all()) for c in checks]
    pv_s = time.perf_counter() - t0
    launches = dict(cuda_ops.LAUNCHES)
    log(f"deck1024 ({m}, {n}), B=1: prove+verify {pv_s:.2f} s (the first at this shape); checks "
        f"{dict(zip(checks._fields, ok))}; launches {launches}; set-up {setup_s:.2f} s")
    require(all(ok), "the verifier rejected the honest 1,024-card deck")
    for k in STAGED_KERNELS:
        require(launches[k] > 0, f"deck1024 did not launch kernel {k}")
    N = m * n
    swap = [1, 0] + list(range(2, N))
    bad = Ciphertexts(map_point(lambda t: t[:, swap], sb.shuffled.c0), sb.shuffled.c1)
    try:
        device_api.raise_by_flags(device_api.verify_shuffle(sb.cv, m, n, sb.keys, sb.deck, bad, proof))
    except ProofVerificationError as e:
        require(e.name == HADAMARD, f"the tampered 1,024-card deck failed with {e.name!r}, expected {HADAMARD!r}")
        log(f"deck1024: tampered deck rejected: {e}")
    else:
        raise AssertionError("a tampered 1,024-card deck was accepted")
    new = sorted(seen - lanes_compared)
    log(f"deck1024: the per-statement MSM kernel ran at shapes {sorted(seen)}; {len(new)} not compared in phase 2c")
    for i, (curve, S, Nm) in enumerate(new):
        require(curve == g.cv.host.name, curve)
        lanes_check(dev, g.cv, g.generator, g.enc.gen_table, S, Nm, 401 + 2 * i, "deck1024 shape")
    return dict(prove_verify_s=pv_s, shapes=sorted(seen), launches=launches)


@contextlib.contextmanager
def fold_shapes(seen: set):
    """Record in `seen` the key (curve, statements) of every fold-kernel
    launch made inside the block."""
    from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve

    launch = cuda_curve.fold_windows_cuda

    def recording(cv, S, c):
        seen.add((cv.host.name, S[0].numel() // (S[0].shape[0] * S[0].shape[-1])))
        return launch(cv, S, c)

    cuda_curve.fold_windows_cuda = recording
    try:
        yield seen
    finally:
        cuda_curve.fold_windows_cuda = launch


def sass_counts(kernel: str, src: str) -> dict:
    """Static instruction counts of each instantiation of `kernel` in the
    library built from `src`, from `cuobjdump -sass`: every IMAD flavour and
    every branch by its full opcode, and all instructions ("all")."""
    import re
    import shutil

    from mental_poker_tpu_torch.ops.cuda import build

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(build.lib_path(src))], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            name = fn.group(1) if kernel in fn.group(1) else None
            if name:
                counts[name] = {"all": 0}
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and ins:
            op, c = ins.group(1), counts[name]
            c["all"] += 1
            if op.startswith(("IMAD", "BRA")):
                c[op] = c.get(op, 0) + 1
    return counts


def imad_count(counts: dict) -> int:
    """IMAD instructions among SASS opcode counts, every flavour (.WIDE,
    .HI, the carry forms .X, .MOV) counted once against the integer
    multiply-add pipe's `IMAD_PER_SM_CLOCK`: the CUDA C++ Programming
    Guide gives one rate for "32-bit integer multiply, multiply-add,
    extended-precision multiply-add", and counting each IMAD.WIDE twice
    would put a device reading of 0.0091 ms at 65,536 additions above the
    card's peak."""
    return sum(v for op, v in counts.items() if op.startswith("IMAD"))


def parallel_phase(dev, g, data, proof, compared: dict, pv_ms: float, card: str) -> dict:
    """8. The parallel layer (`mental_poker_tpu_torch/parallel/`, seventh
    slice) on the main path's B = 128 decks at (2, 26), `msm_nc = 1` but
    where it says otherwise.

    The path, at world size 1 on NCCL (`make_mesh`: a one-rank group over a
    local store; every collective runs and gathers one shard), with the
    launch counts set to 0 just before it and read just after:
    `sharded_remask_step`, `sharded_deck_msm`, `sharded_window_msm` and
    `sharded_prefix_prod` on [128, 52] Fr values, `sharded_commit_step` on
    [128, 2, 26], the deck MSM again at `msm_nc = 8`, and the dry run's
    tier 2 (`shard_batch`, prove, verify, `gather_batch`). Each kernel must
    have been launched in it. Then the checks: the tier-2 proof equal leaf
    for leaf to phase 3's unsharded proof of the same inputs; the remask,
    deck MSM, window MSM and prefix product each held against the
    unsharded path on the same tensors (limb for limb for the remask and
    the prefix product, as points for the deck MSM against `cipher_msm`
    and the window MSM against `msm` and the deck MSM) and timed beside it
    (median of three, host clock, synchronised). `sharded_commit_step` is
    `ck.commit` on the rank's rows, with no collective, so it has no such
    row. Then D = 1, 2 and 4 ranks (`sharding.run_ranks`: sp = D; dp = D
    for the commit and the prove): every rank's local step in turn, timed,
    the gathers emulated, the combines; each result equal to the world size
    1 result, its launches counted apart. Last, every launch at a shape
    that `compared` (kind -> keys) does not hold is held against the
    kernel's plain version. Returns the times, the path's launches, the
    rank-by-rank launches and the shapes checked."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from mental_poker_tpu_torch import config
    from mental_poker_tpu_torch.arguments import device_api
    from mental_poker_tpu_torch.crypto import elgamal
    from mental_poker_tpu_torch.crypto.pedersen import CommitKey
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.ops import msm as msm_mod
    from mental_poker_tpu_torch.parallel import dryrun, sharding
    from mental_poker_tpu_torch.parallel.sharding import block, leaves
    from mental_poker_tpu_torch.utils.rand import GameRng

    t_start = time.perf_counter()
    cv, fr, m, n = g.cv, g.cv.fr, g.m, g.n
    deck, shuffled, pi, rho, rand = data
    B, N = pi.shape
    r = GameRng(808)
    lim = lambda *shape: torch.as_tensor(r.scalar_limbs(cv.host.order, shape, fr.L).astype(np.int32), device=dev)
    k, a, vecs, rs = lim(B, N), fr.to_mont(lim(B, N)), lim(B, m, n), lim(B, m)
    ck = CommitKey(cv, g.commit_g, g.commit_h, WINDOW, dev)
    gen, pk = g.enc.gen_table, g.agg_table

    def clock(fn, reps=3):
        """(the last result, the median ms of `reps` calls)."""
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, sorted(times)[len(times) // 2]

    def same(x, y) -> bool:
        """Limb for limb (and flag for flag)."""
        return len(leaves(x)) == len(leaves(y)) and all(torch.equal(p, q) for p, q in zip(leaves(x), leaves(y)))

    def points(x, y) -> bool:
        """As points: a PointP, or both points of a Ciphertexts."""
        pairs = zip(x, y) if isinstance(x, elgamal.Ciphertexts) else [(x, y)]
        return all(bool(cv.eq(P, Q).all()) for P, Q in pairs)

    mesh = sharding.make_mesh(device=dev)
    log(f"parallel: world size {dist.get_world_size()} on {dist.get_backend()}, mesh {mesh.mesh_dim_names} "
        f"{tuple(mesh.shape)}; {card}")
    sh = lambda t: sharding.shard_deck(mesh, t)
    rows = lambda t: block(t, 0, *sharding.mesh_index(mesh, "dp"))
    sharded = {
        "remask": lambda: sharding.sharded_remask_step(cv, gen, pk, mesh)(sh(deck), sh(pi), sh(rho)),
        "deck_msm": lambda: sharding.sharded_deck_msm(cv, mesh)(*sh(deck), sh(k)),
        "window_msm": lambda: sharding.sharded_window_msm(cv, mesh)(deck.c0, k),
        "prefix_prod": lambda: sharding.sharded_prefix_prod(fr, mesh)(sh(a)),
        "commit": lambda: sharding.sharded_commit_step(ck, mesh)(rows(vecs), rows(rs)),
    }
    ms, local_ms = {}, {}
    with kernel_shapes() as seen:
        # the path alone, its launches counted
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        res = {name: fn() for name, fn in sharded.items()}
        with config.override(msm_nc=NC):
            p8, t8 = clock(sharded["deck_msm"], 1)
        (proof_g, _), t_pv = clock(lambda: dryrun.tier2(mesh, m, n, g.keys, deck, shuffled, pi, rho, rand), 1)
        torch.cuda.synchronize()
        launches = dict(cuda_ops.LAUNCHES)
        log(f"parallel: launches of the path at world size 1 (the five sharded steps, the deck MSM at "
            f"msm_nc = {NC}, tier 2) {launches}")
        for kname, v in launches.items():
            require(v > 0, f"the parallel path did not launch kernel {kname}")

        require(same(proof_g, proof), "parallel: the tier-2 proof differs from the unsharded proof")
        require(points(p8, res["deck_msm"]), f"parallel deck_msm at msm_nc = {NC} differs from nc = 1")
        ms["deck_msm_nc8"] = dict(sharded=t8)
        ms["prove_verify"] = dict(sharded=t_pv, unsharded=pv_ms)
        log(f"parallel deck_msm at msm_nc = {NC}: {t8:.3f} ms, equal as points; tier 2 (B={B}, shard_batch, "
            f"prove, verify, gather_batch): {t_pv:.1f} ms (phase 3's unsharded prove+verify {pv_ms:.1f} ms), "
            f"every flag true, the proof equal to phase 3's leaf for leaf")
        unsharded = {
            "remask": (lambda: sharding.remask_shuffled_step(cv, gen, pk)(deck, pi, rho), same),
            "deck_msm": (lambda: elgamal.cipher_msm(cv, deck, k), points),
            "window_msm": (lambda: msm_mod.msm(cv, deck.c0, k), points),
            "prefix_prod": (lambda: fr.prefix_prod(a, axis=1), same),
        }
        for name, (plain, equal) in unsharded.items():
            _, t_sh = clock(sharded[name])
            want, t_un = clock(plain)
            require(equal(res[name], want), f"parallel {name}: the world size 1 result differs from the unsharded path")
            ms[name] = dict(sharded=t_sh, unsharded=t_un)
            log(f"parallel {name} [B={B}, N={N}], world size 1: sharded {t_sh:.3f} ms, unsharded {t_un:.3f} ms; "
                f"equal {'limb for limb' if equal is same else 'as points'}")
        require(points(res["window_msm"], res["deck_msm"].c0), "parallel: the window MSM differs from the deck MSM")

        prove = lambda *rows_: device_api.prove_shuffle(cv, m, n, g.keys, *rows_)
        steps = {
            "remask": (sharding.remask_step(cv, gen, pk), (deck, pi, rho)),
            "deck_msm": (sharding.deck_msm_step(cv), (*deck, k)),
            "window_msm": (sharding.window_msm_step(cv), (deck.c0, k)),
            "prefix_prod": (sharding.prefix_prod_step(fr), (a,)),
            "commit": (sharding.commit_step(ck), (vecs, rs)),
            "prove": (sharding.batch_step(prove, 5), (deck, shuffled, pi, rho, rand)),
        }
        want = {**res, "window_msm": res["deck_msm"].c0, "prove": proof}
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        for D in (1, 2, 4):
            for name, (step, whole) in steps.items():
                times = []

                def timed(fn):
                    out, t = clock(fn, 1)
                    times.append(t)
                    return out

                out = sharding.run_ranks(step, D, *whole, call=timed)
                equal = points if name in ("deck_msm", "window_msm") else same
                require(equal(out, want[name]), f"parallel {name} at D = {D}: the combined result differs from world size 1")
                local_ms.setdefault(name, {})[D] = times
            log(f"parallel D={D}: every rank's local step, gathers emulated, combined: equal to world size 1; "
                f"local steps (ms, by rank): " + "; ".join(f"{k_} {[round(t, 3) for t in v[D]]}" for k_, v in local_ms.items()))
        torch.cuda.synchronize()
        launches_ranks = dict(cuda_ops.LAUNCHES)
    log(f"parallel: launches of the rank-by-rank runs at D = 1, 2, 4 (not the path's) {launches_ranks}")

    new = check_new_shapes(dev, g, seen, compared, 901, "parallel")
    dist.destroy_process_group()
    log(f"parallel: phase 8 took {time.perf_counter() - t_start:.1f} s")
    return dict(ms=ms, local_ms=local_ms, launches=launches, launches_ranks=launches_ranks,
                new_shapes={k_: len(v) for k_, v in new.items()}, seen=seen)


@contextlib.contextmanager
def kernel_shapes():
    """Record the shape key of every kernel launch made inside the block, by
    kind: {"elementwise": `elementwise_lanes` keys, "lanes":
    `lanes_shapes`', "chunked": `chunked_shapes`', "fold": `fold_shapes`'}."""
    seen = {kind: set() for kind in ("elementwise", "lanes", "chunked", "fold")}
    with elementwise_lanes(seen["elementwise"]), lanes_shapes(seen["lanes"]), chunked_shapes(seen["chunked"]), \
            fold_shapes(seen["fold"]):
        yield seen


def check_new_shapes(dev, g, seen: dict, compared: dict, seed: int, where: str) -> dict:
    """Every launch of `seen` (`kernel_shapes`) at a shape that `compared`
    (kind -> keys) does not hold, held against the kernel's plain version
    on the Stark curve of `g`. Returns the new keys by kind."""
    cv, gen = g.cv, g.enc.gen_table
    t0 = time.perf_counter()
    new = {kind: sorted(seen[kind] - compared[kind]) for kind in seen}
    for i, key in enumerate(new["elementwise"]):
        elementwise_check(dev, g, key, seed + 2 * i)
    for i, (curve, S, Nm) in enumerate(new["lanes"]):
        require(curve == cv.host.name, curve)
        lanes_check(dev, cv, g.generator, gen, S, Nm, seed + 50 + 2 * i, f"{where} shape")
    for i, (curve, S, Nm, nck) in enumerate(new["chunked"]):
        require(curve == cv.host.name, curve)
        key, _ = chunked_check(dev, cv, g.generator, gen, S, Nm, nck, seed + 70 + 2 * i, f"{where} shape")
        require(key == (curve, S, Nm, nck), (key, nck))
    for curve, S in new["fold"]:
        require(curve == cv.host.name, curve)
        fold_check(dev, cv, g.generator, gen, S)
    log(f"{where}: every kernel equal to plain at the phase's new shapes ({ {k_: len(v) for k_, v in new.items()} } "
        f"of { {k_: len(v) for k_, v in seen.items()} }; {time.perf_counter() - t0:.1f} s)")
    return new


@contextlib.contextmanager
def environment(**values):
    """The block with the `MPTPU_*` knobs of the bench and the scaling curve
    unset but `values` (str), and the process config re-read from them; the
    environment and the config restored after."""
    from mental_poker_tpu_torch import config

    saved, cfg = dict(os.environ), config.get_config()
    for k in [k for k in os.environ if k.startswith("MPTPU_")]:
        del os.environ[k]
    os.environ.update(values)
    config.set_config(None)
    try:
        yield
    finally:
        os.environ.clear()
        os.environ.update(saved)
        config.set_config(cfg)


STAGE_NAMES = ("stmt", "commit", "abs_pts", "abs_const", "abs_me", "make_a", "make_b", "prod_prep", "had_mids",
               "had_prep", "zero_prep", "zero_open", "svp_prep", "svp_open", "me_prep", "me_open", "ver_prep",
               "coeffs", "combo", "flags")


def stage_calls(curve: str, n: int) -> dict:
    """The stage calls of one prove+verify at (2, n) (`arguments/staged.py`),
    by the JAX package's program keys: the commits by their count K, the
    absorbs by (K, challenges), the verifier's combos by (rows, width)."""
    m, N = 2, 2 * n
    k = lambda name, *extra: (name, curve, m, n) + extra
    calls = {k(name): 1 for name in STAGE_NAMES[5:18]}
    calls.update({k("stmt"): 2, k("abs_me"): 2, k("abs_const", b"hadamard:no-mid", 2): 2, k("flags", False): 1})
    calls.update({("commit", curve, n, K): c for K, c in ((2, 2), (1, 1), (7, 1), (3, 1), (5, 1), (9, 1))})
    calls.update({k("abs_pts", K, nch): 2 for K, nch in ((2, 1), (2, 2), (1, 0), (7, 1), (3, 1))})
    calls.update({k("combo", 2, 4): 2, k("combo", 2, 1): 1, k("combo", 7, 8): 1, k("combo", 4, N): 1})
    return calls


def bench_phase(dev, g, data, proof, prove_verify, compared: dict, pv_ms: float, reps: int = 3) -> dict:
    """9. The bench's knobs (`mental_poker_tpu_torch/bench.py`, eighth
    slice) at full width, `msm_nc = 1`, the kernels' launch shapes recorded
    throughout.

    (a) shuffle52 at B = 128, (2, 26) with `stage_timing` on
    (`bench_shuffle52`: its set-up, then `shuffle52_result`, `reps` timed
    runs), its launch counts set to 0 just before and read just after (with
    (a)'s proof below): every stage of `STAGE_NAMES` in the report, each
    key's calls those of `stage_calls` in each of the 1 + `reps` runs, the
    rows' steady ms for one prove+verify summed no more than the mean run;
    then, timing still on, phase 3's batch proved again
    (`prove_verify(data)`), the proof equal to phase 3's `proof` leaf for
    leaf. (b) One timed run of (a)'s set-up with `profile_dir` set to a
    temporary directory, the stage report still on: the report printed
    first, its calls those of the warm and the timed run (the traced run
    not among them); the Chrome trace written, the busy ms, idle share,
    device ms by kernel and by stage and the top device operations printed;
    `mont_mul`, `point_add` and `msm_lanes` among the traced device
    operations; each stage's traced calls those of one prove+verify, their
    device ms summed within the busy ms; the idle share also against
    `pv_ms`, phase 3's median B = 128 prove+verify (timing off, untraced). (c) `bench.main()` with `MPTPU_BENCH_BATCH=1` and 2 reps, then with
    `MPTPU_BENCH_SMOKE=1` and 1: each JSON line read back with that many
    runs, each run's proofs verified (the bench raises otherwise). (d)
    `parallel/scaling.py`'s `main` at world size 1 on NCCL, B = 128, (2,
    26), 2 timed runs: the dp = 1 row, every flag true, dp 2, 4 and 8 named
    as not run. Last, every launch at a shape `compared` does not hold
    against its kernel's plain version."""
    import io
    import tempfile

    import torch

    from mental_poker_tpu_torch import bench, config
    from mental_poker_tpu_torch.arguments import staged
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.parallel import scaling
    from mental_poker_tpu_torch.parallel.sharding import leaves

    t_start = time.perf_counter()
    n = 26
    runs = 1 + reps
    out = {}
    with kernel_shapes() as seen:
        # (a) the stage report; launch counts around (a) alone
        staged.STAGE_TIMES.clear()
        err = io.StringIO()
        torch.cuda.synchronize()
        cuda_ops.reset_launches()
        with config.override(stage_timing=True, fixed_window_bits=WINDOW), contextlib.redirect_stderr(err):
            sb = bench.shuffle_setup(2, n, BATCH, 1234, b"bench", dev)  # `bench_shuffle52`'s set-up, kept for (b)
            res = bench.shuffle52_result(sb, reps, dev)
            report = staged.stage_report()
            proof_t, checks_t = prove_verify(data)
        launches = dict(cuda_ops.LAUNCHES)
        for line in err.getvalue().splitlines():
            log(f"  {line}")
        log(f"bench shuffle52 B={BATCH} with stage timing: {res}; launches {launches}")
        for k in STAGED_KERNELS:
            require(launches[k] > 0, f"the bench's shuffle52 did not launch kernel {k}")
        require(sorted({key[0] for key, *_ in report}) == sorted(STAGE_NAMES),
                f"stage report names {sorted({key[0] for key, *_ in report})}")
        want = {key: c * runs for key, c in stage_calls(g.cv.host.name, n).items()}
        got = {key: calls for key, _, calls, _ in report}
        require(got == want, f"stage calls differ from the flow's: {sorted(set(got.items()) ^ set(want.items()))}")
        per_run_ms = sum(steady * calls / runs for _, steady, calls, _ in report)
        mean_ms = sum(res["runs_s"]) / len(res["runs_s"]) * 1e3
        require(per_run_ms <= mean_ms, f"the stages' steady ms {per_run_ms:.1f} exceed the mean run {mean_ms:.1f}")
        require(all(bool(c.all()) for c in checks_t), "the verifier rejected phase 3's batch with stage timing on")
        diff = [i for i, (a_, b_) in enumerate(zip(leaves(proof), leaves(proof_t))) if not torch.equal(a_, b_)]
        require(not diff and len(leaves(proof)) == len(leaves(proof_t)),
                f"the proof made with stage timing on differs from phase 3's at leaves {diff}")
        log(f"bench stage report: {len(report)} keys, the {len(STAGE_NAMES)} stages, each key's calls the flow's "
            f"x {runs} runs; the stages' steady {per_run_ms:.1f} ms of a {mean_ms:.1f} ms mean run; phase 3's batch "
            f"proved with timing on equals its proof ({len(leaves(proof_t))} leaves); (a) at "
            f"{time.perf_counter() - t_start:.1f} s")
        out["stage_report_b128"] = [[list(map(str, key)), steady, calls, first] for key, steady, calls, first in report]
        out.update(shuffle52_b128=res, stages_ms_per_run=per_run_ms)

        # (b) one traced run of (a)'s set-up, the stage report still on
        err = io.StringIO()
        staged.STAGE_TIMES.clear()
        with tempfile.TemporaryDirectory() as tmp, config.override(profile_dir=tmp, stage_timing=True), \
                contextlib.redirect_stderr(err):
            res_b = bench.shuffle52_result(sb, 1, dev)
            path = os.path.join(tmp, "bench_trace.json")
            require(os.path.isfile(path) and os.path.getsize(path) > 0, f"no trace written at {path}")
            trace_bytes = os.path.getsize(path)
        lines = err.getvalue().splitlines()
        for line in lines:
            log(f"  {line}")
        field = lambda head: [json.loads(line[len(head):]) for line in lines if line.startswith(head)]
        busy = [line for line in lines if line.startswith("# device busy ")]
        ops = [line for line in lines if line.startswith("# device op ")]
        by_kernel, by_stage = field("# kernel device ms "), field("# stage device ms [ms, calls] ")
        require(len(busy) == 1 and ops and len(by_kernel) == 1 and len(by_stage) == 1,
                "the traced run's summary is missing")
        for k in STAGED_KERNELS:
            require(by_kernel[0][k] > 0, f"kernel {k} is not among the traced device operations")
        calls = {}
        for key, c in stage_calls(g.cv.host.name, n).items():
            calls[key[0]] = calls.get(key[0], 0) + c
        require({k: v[1] for k, v in by_stage[0].items()} == calls, f"stage device calls {by_stage[0]}")
        staged_ms = sum(v[0] for v in by_stage[0].values())
        require(staged_ms <= by_kernel[0]["all"], f"the stages' device ms {staged_ms} exceed the busy ms")
        report_calls = [int(line.split("ms/call  x")[1].split()[0]) for line in lines if "ms/call  x" in line]
        first_trace = min(i for i, line in enumerate(lines) if line.startswith("# trace: "))
        require(sum(report_calls) == 2 * sum(calls.values())
                and all("ms/call  x" not in line for line in lines[first_trace:]),
                f"the stage report counts the traced run or follows it: calls {sum(report_calls)}")
        idle_p3 = 1 - by_kernel[0]["all"] / pv_ms
        log(f"bench trace: {trace_bytes} bytes of Chrome trace; the stages' device ms {staged_ms:.3f} of "
            f"{by_kernel[0]['all']:.3f} busy; idle {idle_p3:.4f} of phase 3's {pv_ms:.1f} ms median B={BATCH} "
            f"prove+verify (timing off, untraced); {res_b}; (b) at {time.perf_counter() - t_start:.1f} s")
        out.update(trace_bytes=trace_bytes, traced_kernel_device_ms=by_kernel[0], trace_summary=busy[0],
                   stage_device_ms=by_stage[0], idle_share_of_phase3_median=idle_p3)

        # (c) main() through the config: the latency mode and the smoke shape
        for knob in ({"MPTPU_BENCH_BATCH": "1", "MPTPU_BENCH_REPS": "2"},
                     {"MPTPU_BENCH_SMOKE": "1", "MPTPU_BENCH_REPS": "1"}):
            buf = io.StringIO()
            with environment(MPTPU_MSM_NC="1", **knob), contextlib.redirect_stdout(buf):
                rc = bench.main()
            line = json.loads(buf.getvalue().strip().splitlines()[-1])
            require(rc == 0 and line["metric"] == "torch_shuffle52_prove_verify_pairs_per_s"
                    and len(line["runs_s"]) == int(knob["MPTPU_BENCH_REPS"]), f"bench main() with {knob}: rc {rc}, {line}")
            log(f"bench main() with {knob}: {line}; at {time.perf_counter() - t_start:.1f} s")
            out["main_" + "_".join(f"{k}={v}" for k, v in knob.items())] = line

        # (d) the scaling curve at world size 1 on NCCL
        buf = io.StringIO()
        with environment(MPTPU_SCALING_B=str(BATCH), MPTPU_SCALING_REPS="2"), contextlib.redirect_stdout(buf):
            rc = scaling.main(["--m", "2", "--n", str(n)])
        lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]
        for line in lines:
            log(f"scaling: {line}")
        rows = [line for line in lines if "dp" in line]
        not_run = [line["not_run_dp"] for line in lines if "not_run_dp" in line]
        require(rc == 0 and [r["dp"] for r in rows] == [1] and rows[0]["total_B"] == BATCH
                and not_run == [[2, 4, 8]] and lines[-1]["metric"] == "dp_scaling_overhead",
                f"scaling curve: rc {rc}, lines {lines}")
        out["scaling_dp1"] = rows[0]
        log(f"bench: (d) at {time.perf_counter() - t_start:.1f} s")

    new = check_new_shapes(dev, g, seen, compared, 1101, "bench")
    log(f"bench: phase 9 took {time.perf_counter() - t_start:.1f} s")
    return dict(out, launches=launches, new_shapes={k_: len(v) for k_, v in new.items()}, seen=seen)


def fused_phase(dev, g, data, data1, proof1, bad, launches1, pv1_ms, round5, compared: dict, hash_seen: set,
                reps: int = REPS) -> dict:
    """10. The fused latency mode (`arguments/fused.py`, ninth slice) on the
    main path at full width: Stark, (2, 26), window-8 tables (`g`, phase
    3's), the kernels' launch shapes recorded throughout.

    (a) Phase 3's B=1 deck (`data1`) with `fuse_b_max = 1`, `msm_nc = 1`:
    the first prove+verify captures the two graphs; the proof equals
    `proof1` (phase 3's staged B=1 proof) leaf for leaf, every flag is true,
    and phase 3's tampered deck (`bad`) fails with "Hadamard Product (5.1)".
    The launches the two captures recorded equal `launches1` (phase 3's B=1
    prove+verify). The median of `reps` replayed prove+verify, beside
    `pv1_ms` (phase 3's staged median); one more replay traced by
    `profiling.trace` (device-busy ms; idle share against the median).
    (b) A second statement (another game: seed and aggregate key) through
    the same graphs, no capture made, equal to its staged proof, and (a)'s
    proof still equal to `proof1`. (c) The first four decks of phase 3's
    B=128 batch with `fuse_b_max = 4`: equal to their staged proof, every
    flag true. (d) `data1` at `msm_nc = 8`: equal to (a)'s proof, its
    captures launching the chunked and fold kernels and not the lane
    kernel. (e) `play_round(seed=7, m=2, n=26)` with `fuse_b_max = 1`: the
    cards of phase 5d (`round5`: its seconds and cards). (f) `bench.main()`
    with `MPTPU_BENCH_BATCH=1`, `MPTPU_FUSE_B=1`: its JSON line, with
    `fuse_b_max` 1. `FUSED_MISSES` is printed. Last, every launch at a
    shape `compared` does not hold against its kernel's plain version.
    (a)'s captures record the transcript kernels' shapes in `hash_seen`."""
    import io
    import tempfile

    import numpy as np
    import torch

    from mental_poker_tpu_torch import bench, config, params, profiling
    from mental_poker_tpu_torch.arguments import device_api, fused
    from mental_poker_tpu_torch.arguments.device import leaves
    from mental_poker_tpu_torch.crypto import elgamal
    from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
    from mental_poker_tpu_torch.crypto.errors import HADAMARD, ProofVerificationError
    from mental_poker_tpu_torch.models.round import play_round
    from mental_poker_tpu_torch.ops import cuda as cuda_ops
    from mental_poker_tpu_torch.ops.curve import map_point
    from mental_poker_tpu_torch.utils.rand import GameRng

    t_start = time.perf_counter()
    cv, m, n = g.cv, 2, 26
    N = m * n
    q, L = cv.host.order, cv.fr.L
    out = {}
    misses0 = fused.FUSED_MISSES
    same = lambda a, b: len(leaves(a)) == len(leaves(b)) and all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))

    def prove_verify(gg, stmt):
        deck, shuffled, pi, rho, rand = stmt
        proof = device_api.prove_shuffle(cv, m, n, gg.keys, deck, shuffled, pi, rho, rand)
        checks = device_api.verify_shuffle(cv, m, n, gg.keys, deck, shuffled, proof)
        torch.cuda.synchronize()
        return proof, checks

    def captured(run):
        """run() -> (its result, the graphs it captured: {name: fused.Captured})."""
        before = set(fused.GRAPHS)
        res = run()
        return res, {key[0]: fused.GRAPHS[key] for key in set(fused.GRAPHS) - before}

    def all_true(checks) -> bool:
        return all(bool(c.all()) for c in checks)

    with kernel_shapes() as seen:
        # (a) phase 3's B=1 deck
        with config.override(fuse_b_max=1, msm_nc=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with hash_shapes(hash_seen):  # the transcript kernels' shapes in `shuffle52.table` (phase 11)
                (proof_f, checks_f), caps = captured(lambda: prove_verify(g, data1))
            first_s = time.perf_counter() - t0
            require(sorted(caps) == ["fused_prove", "fused_verify"], f"captured {sorted(caps)}")
            cap_launches = {k: sum(c.launches[k] for c in caps.values()) for k in cuda_ops.LAUNCHES}
            # a staged draw loops until every lane accepted (K = 8 a round), a fused draw is one round
            loops = {k: v for k, v in launches1.items() if k != "chacha_draw"}
            require({k: cap_launches[k] for k in loops} == loops
                    and 0 < cap_launches["chacha_draw"] <= launches1["chacha_draw"],
                    f"the captures launched {cap_launches}, phase 3's B=1 {launches1}")
            require(same(proof_f, proof1), "the fused B=1 proof differs from phase 3's staged B=1 proof")
            require(all_true(checks_f), f"the fused verifier rejected an honest deck: {checks_f}")
            checks_bad = device_api.verify_shuffle(cv, m, n, g.keys, data1[0], bad, proof1)
            try:
                device_api.raise_by_flags(checks_bad)
            except ProofVerificationError as e:
                require(e.name == HADAMARD, f"the fused verifier failed the tampered deck with {e.name!r}")
            else:
                raise AssertionError("the fused verifier accepted a tampered deck")
            cuda_ops.reset_launches()
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                prove_verify(g, data1)
                times.append((time.perf_counter() - t0) * 1e3)
            require(not any(cuda_ops.LAUNCHES.values()), f"a replay went through a wrapper: {cuda_ops.LAUNCHES}")
            med = sorted(times)[len(times) // 2]
            with tempfile.TemporaryDirectory() as tmp:
                tr = profiling.trace(lambda: prove_verify(g, data1), tmp, "fused_b1", dev)
        capture_s = {name: c.capture_s for name, c in caps.items()}
        busy = tr["device_busy_ms"]
        idle = 1 - busy / med
        log(f"fused (a) B=1: first prove+verify {first_s:.2f} s (captures {capture_s} s); capture launches "
            f"{cap_launches} = phase 3's B=1; proof equal to phase 3's staged proof ({len(leaves(proof_f))} leaves); "
            f"tampered deck rejected; replayed prove+verify {med:.2f} ms median (runs {[round(t, 2) for t in times]}), "
            f"{1e3 / med:.3f} pairs/s, beside phase 3's staged {pv1_ms:.1f} ms ({1e3 / pv1_ms:.3f} pairs/s); "
            f"traced replay ({tr['wall_s'] * 1e3:.2f} ms): device busy {busy:.3f} ms in {tr['device_launches']} "
            f"launches, idle share {idle:.4f} of the median replay, {tr['idle_share_of_traced']:.4f} of the traced "
            f"one; kernel device ms {tr['kernel_device_ms']}; top {tr['top_ops'][:5]}")
        out.update(first_s=first_s, capture_s=capture_s, replay_ms=times, replay_median_ms=med,
                   replay_pairs_per_s=1e3 / med, staged_b1_median_ms=pv1_ms, device_busy_ms=busy,
                   device_launches=tr["device_launches"], kernel_device_ms=tr["kernel_device_ms"],
                   idle_share_of_median=idle, traced_wall_ms=tr["wall_s"] * 1e3)
        launches = cap_launches

        # (b) a second statement, another game, through the same graphs
        g2 = params.setup(GameRng(4321), m, n, c=WINDOW, device=dev)
        r = GameRng(4322)
        ab = torch.as_tensor(r.scalar_limbs(q, (2, 1, N), L).astype(np.int32), device=dev)
        deck2 = Ciphertexts(g2.enc.gen_table.mul(ab[0]), g2.enc.gen_table.mul(ab[1]))
        pi2 = torch.as_tensor(r.permutation(N).astype(np.int64), device=dev)[None]
        rho2 = torch.as_tensor(r.scalar_limbs(q, (1, N), L).astype(np.int32), device=dev)
        perm2 = Ciphertexts(*(map_point(lambda t: torch.gather(t, 1, pi2[..., None].expand(t.shape)), c)
                              for c in deck2))
        shuf2 = elgamal.cipher_add(cv, perm2, elgamal.encrypt_zero(g2.enc, g2.agg_table, rho2))
        data2 = (deck2, shuf2, pi2, rho2, device_api.sample_shuffle_rand(r, m, n, L, q, batch=1, device=dev))
        with config.override(fuse_b_max=1, msm_nc=1):
            (proof2_f, checks2_f), caps2 = captured(lambda: prove_verify(g2, data2))
        with config.override(fuse_b_max=0, msm_nc=1):
            proof2_s, _ = prove_verify(g2, data2)
        require(not caps2, f"the second statement captured {sorted(caps2)}: its signature should be (a)'s")
        require(same(proof2_f, proof2_s) and all_true(checks2_f), "the second statement's fused proof differs "
                "from its staged proof or was rejected")
        require(not same(proof2_f, proof_f), "the second statement's proof equals the first's")
        require(same(proof_f, proof1), "the second statement changed (a)'s returned proof")
        log(f"fused (b): a second game through the same graphs equals its staged proof; (a)'s proof unchanged")

        # (c) B = 4
        deck, shuffled, pi, rho, rand = data
        cut = lambda c: Ciphertexts(*(map_point(lambda t: t[:4], p_) for p_ in c))
        data4 = (cut(deck), cut(shuffled), pi[:4], rho[:4], type(rand)(*(t[:4] for t in rand)))
        with config.override(fuse_b_max=4, msm_nc=1):
            (proof4_f, checks4_f), caps4 = captured(lambda: prove_verify(g, data4))
        with config.override(fuse_b_max=0, msm_nc=1):
            proof4_s, _ = prove_verify(g, data4)
        require(sorted(caps4) == ["fused_prove", "fused_verify"], f"B=4 captured {sorted(caps4)}")
        require(same(proof4_f, proof4_s) and all_true(checks4_f), "the fused B=4 proof differs from staged B=4")
        out["capture_s_b4"] = {name: c.capture_s for name, c in caps4.items()}
        log(f"fused (c) B=4: equal to the staged B=4 proof, every flag true; captures {out['capture_s_b4']} s")

        # (d) B = 1 at msm_nc = 8: the chunked and fold kernels inside a graph
        with config.override(fuse_b_max=1, msm_nc=NC):
            (proof8_f, checks8_f), caps8 = captured(lambda: prove_verify(g, data1))
        launches8 = {k: sum(c.launches[k] for c in caps8.values()) for k in cuda_ops.LAUNCHES}
        require(sorted(caps8) == ["fused_prove", "fused_verify"], f"nc = {NC} captured {sorted(caps8)}")
        require(launches8["msm_chunked"] > 0 and launches8["fold_windows"] == launches8["msm_chunked"]
                and not launches8["msm_lanes"], f"the nc = {NC} graphs launched {launches8}")
        require(same(proof8_f, proof_f) and all_true(checks8_f), f"the fused nc = {NC} proof differs from (a)'s")
        out["capture_s_nc8"] = {name: c.capture_s for name, c in caps8.items()}
        log(f"fused (d) B=1, msm_nc={NC}: equal to (a)'s proof; capture launches {launches8}")

        # (e) the reference's round, fused
        round_s, round_opened = round5
        with config.override(fuse_b_max=1, msm_nc=1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opened = play_round(seed=7, m=m, n=n, num_shuffles=4, device=dev)
            torch.cuda.synchronize()
            round_f = time.perf_counter() - t0
        require(opened == round_opened, f"the fused round opened {opened}, phase 5d's {round_opened}")
        out.update(round_s=round_f, round_staged_s=round_s)
        log(f"fused (e) round (2, {n}), 4 players, 4 shuffles: {round_f:.2f} s (phase 5d staged {round_s:.2f} s); "
            f"opened {opened}, phase 5d's cards")

        # (f) the bench's latency mode, fused
        buf = io.StringIO()
        with environment(MPTPU_MSM_NC="1", MPTPU_BENCH_BATCH="1", MPTPU_FUSE_B="1", MPTPU_BENCH_REPS="3"), \
                contextlib.redirect_stdout(buf):
            rc = bench.main()
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        require(rc == 0 and line["fuse_b_max"] == 1 and len(line["runs_s"]) == 3
                and line["metric"] == "torch_shuffle52_prove_verify_pairs_per_s", f"fused bench main(): rc {rc}, {line}")
        out["bench_b1_fused"] = line
        log(f"fused (f) bench main() with MPTPU_BENCH_BATCH=1 MPTPU_FUSE_B=1: {line}")

    out["fused_misses"] = fused.FUSED_MISSES - misses0
    log(f"fused: FUSED_MISSES {fused.FUSED_MISSES} ({out['fused_misses']} in this phase); "
        f"{len(fused.GRAPHS)} graphs captured")
    new = check_new_shapes(dev, g, seen, compared, 1201, "fused")
    out["new_shapes"] = {k_: len(v) for k_, v in new.items()}
    out["phase_s"] = time.perf_counter() - t_start
    log(f"fused: phase 10 took {out['phase_s']:.1f} s")
    return dict(out, launches=launches, launches_nc8=launches8)

if __name__ == "__main__":
    sys.exit(main())
