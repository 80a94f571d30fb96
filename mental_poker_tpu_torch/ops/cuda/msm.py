"""Per-statement MSM: the Hopper kernel and its plain PyTorch version.

Replaces `mental_poker_tpu/ops/pallas/msm.py::_msm_kernel` (builder
`_build_msm`, entry `msm_lanes` with nc=1, reached through `ops/msm.py::msm`).
Source: `csrc/msm.cu` with the shared routines of `csrc/mont.cuh`.

- What it computes: for each statement s, sum_i k[s, i] * P[s, i] with
  4-bit windows (`WINDOW`, the JAX default; W = ceil(bits / 4) = 63 windows
  for Stark scalars). The kernel has the window and W built in.
- What bounds it on the H100: integer multiply-adds, and for a narrow call
  the latency of one sequential chain: per statement, a multiples table
  (14 additions per point), N additions per window, then a fold of
  W * 5 additions that cannot run in parallel.
- What the design does about it: the TPU kernel puts statements on vector
  lanes and selects table entries with masks; here a first kernel builds
  every point's table with one thread per (statement, point), and a second
  runs two statements per block with one thread per (statement, window),
  so the W window sums of a statement accumulate in parallel; then a lane
  group of eight of the block's threads folds each statement with the
  products of every addition spread over its lanes (`csrc/fold.cuh`), three
  products on the critical path of an addition.
  `ops/msm.py::msm` splits the points of few-statement calls over several
  statements (the wide-split mapping) so that narrow calls still fill the
  card.

The plain version runs the same schedule (table entries t*P = (t-1)*P + P,
window sums in point order from the identity, MSB-first fold), so the two
agree limb for limb on the projective result.

The chunked kernel (`msm_chunked`, source `csrc/msm_chunked.cu`) replaces
`mental_poker_tpu/ops/pallas/msm.py::_msm_kernel_chunked` in its `emit` mode
(builder `_build_msm_chunked`, adapter `_kern_drop_fld`), reached through
`msm_lanes` when `config.msm_nc` (`MPTPU_MSM_NC`) is above 1:

- What it computes: the W window sums of each statement, NC points per
  sequential step (`chunk_points`: NC = min(nc, N, CHUNK_MAX),
  NB = ceil(N / NC) steps): the NC points' table entries by digit, a
  pairwise tree over them (left to right, an odd element carried up), one
  accumulate per step. `msm_lanes` folds the sums with the fold kernel
  (`ops/cuda/curve.py::fold_windows`).
- What bounds it on the H100: integer multiply-adds, 14 table additions per
  point and NB * NC additions per window (the tree's NC - 1 and one
  accumulate per chunk, pad slots included). A TPU level's additions are
  independent; a lane per chunk slot would leave half the lanes idle at
  each level of the tree.
- What the design does about it: the tables are built by `msm.cu`'s table
  kernel (`csrc/msm_table.cuh`); then one thread per (statement, window),
  two statements to a block of 2 W threads, walks its window's chunks in
  order and evaluates each chunk's tree in post-order on a small stack in
  shared memory (slot values pushed left to right, the two newest partial
  sums merged while they cover blocks of one size, the rest folded from the
  newest down at the chunk's end), which is the TPU's pairing with its odd
  carry for every NC. The launch sizes the stack for NC (k + 1 points a
  thread in shared memory for up to 2^(k+1) points a step: three at
  NC = 8, six at 64), so that small NC keep their occupancy. Every lane adds at every step and no barrier
  is waited on. One window's dependent chain is 14 table additions, then
  NB * NC additions. The window sums go out, so the fold chain runs once
  per statement in the fold kernel.

`msm_chunked_plain` runs the TPU schedule (identity window sums, identity for
digit 0 and for the pad slots past N, the same tree pairing, one accumulate
per chunk), batched over all chunks at once, so the kernel, the plain version
and the JAX kernel agree limb for limb on the window sums and, folded, on
the projective result.
"""

from __future__ import annotations

import ctypes

import torch

from ...config import get_config
from . import LAUNCHES, build
from .curve import a_case, curve_words, fold_windows, fold_windows_plain, point_add_plain
from .field import _check

_ARGS = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

_CHUNKED_ARGS = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
                 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

WINDOW = 4  # window bits; csrc/msm_table.cuh's kC
# The most points per step the chunked kernel takes (csrc/msm_chunked.cu's
# kMaxNC): the JAX package's largest NC is 52, its most points per call.
# Above it both versions run CHUNK_MAX points a step, so no nc is refused.
CHUNK_MAX = 64


def chunk_points(nc: int, N: int) -> int:
    """NC, the points per step the chunked MSM runs for a setting nc >= 1 on
    statements of N points: min(nc, N, CHUNK_MAX)."""
    if nc < 1:
        raise ValueError(f"msm_chunked: points per step must be at least 1, got nc={nc}")
    return min(nc, N, CHUNK_MAX)


def num_windows(cv) -> int:
    return -(-cv.fr.bits // WINDOW)


def digits(k: torch.Tensor, c: int, W: int) -> torch.Tensor:
    """Canonical scalar limbs [..., Lk] -> c-bit digits [..., W], LSB first."""
    if 16 % c:
        raise ValueError("window width must divide the 16-bit limb")
    per = 16 // c
    w = torch.arange(W, device=k.device)
    limb = k[..., w // per]
    return (limb >> ((w % per) * c)) & ((1 << c) - 1)


def _multiples(cv, P):
    """Multiples tables t*P for t < 2^WINDOW, one per coordinate [S, N, T, L]:
    entry 0 the identity, entry t = entry (t - 1) + P."""
    px, py, pz = P
    entries = [cv.identity_like(px), (px, py, pz)]
    for _ in range((1 << WINDOW) - 2):
        entries.append(point_add_plain(cv, entries[-1], (px, py, pz)))
    return [torch.stack([e[j] for e in entries], dim=2) for j in range(3)]


def msm_lanes_plain(cv, P, k: torch.Tensor):
    """Plain PyTorch version of the kernel's schedule (any device).
    P: (x, y, z) coordinates [S, N, L]; k: canonical limbs [S, N, Lk]."""
    px = P[0]
    S, N, L = px.shape
    if N == 0:
        return cv.identity_like(px.new_zeros((S, L)))
    c = WINDOW
    W = num_windows(cv)
    add = lambda A, B: point_add_plain(cv, A, B)
    tbl = _multiples(cv, P)
    d = digits(k, c, W).long()  # [S, N, W]
    acc = cv.identity_like(px.new_zeros((S, W, L)))
    for i in range(N):
        idx = d[:, i, :, None].expand(S, W, L)
        e = tuple(torch.gather(t[:, i], 1, idx) for t in tbl)
        acc = add(acc, e)
    return fold_windows_plain(cv, tuple(a.movedim(1, 0) for a in acc), c)


def msm_lanes_cuda(cv, P, k: torch.Tensor):
    """Launch the kernel on CUDA tensors: P coordinates [S, N, L] and k
    [S, N, Lk], all contiguous int32."""
    px = P[0]
    if px.device.type != "cuda":
        raise ValueError("msm_lanes_cuda: inputs must be CUDA tensors")
    if px.dim() != 3 or k.dim() != 3 or k.shape[:2] != px.shape[:2]:
        raise ValueError(f"msm_lanes_cuda: points {tuple(px.shape)} and scalars {tuple(k.shape)}")
    L, Lk = cv.fq.L, cv.fr.L
    for t in P:
        if t.shape != px.shape:
            raise ValueError("msm_lanes_cuda: coordinate shapes differ")
        _check(t, L, px.device, "msm_lanes")
    _check(k, Lk, px.device, "msm_lanes")
    S, N = px.shape[0], px.shape[1]
    if S == 0 or N == 0:
        if S == 0:
            return tuple(px.new_empty((0, L)) for _ in range(3))
        return cv.identity_like(px.new_zeros((S, L)))
    out = [px.new_empty((S, L)) for _ in range(3)]
    tbl = torch.empty(S * N * (1 << WINDOW) * 3 * (L // 2), dtype=torch.int32, device=px.device)
    consts = curve_words(cv)
    fn = build.function("msm.cu", "mp_msm_lanes", _ARGS)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    build.check(
        fn(L, num_windows(cv), a_case(cv), *(t.data_ptr() for t in P), k.data_ptr(), Lk, tbl.data_ptr(),
           *(o.data_ptr() for o in out), S, N, consts.ctypes.data, stream),
        "msm_lanes",
    )
    LAUNCHES["msm_lanes"] += 1
    return tuple(out)


def msm_chunked_plain(cv, P, k: torch.Tensor, nc: int):
    """Plain PyTorch version of the chunked kernel's schedule (any device):
    the window sums (x, y, z) [W, S, L]. P: coordinates [S, N, L]; k:
    canonical limbs [S, N, Lk]. Each step's additions are batched over all
    chunks; their operands and order are the kernel's."""
    px = P[0]
    S, N, L = px.shape
    W = num_windows(cv)
    NC = chunk_points(nc, N)
    if N == 0:
        return tuple(cv.identity_like(px.new_zeros((W, S, L))))
    NB = -(-N // NC)
    add = lambda A, B: point_add_plain(cv, A, B)
    tbl = _multiples(cv, P)
    idx = digits(k, WINDOW, W).long()[..., None].expand(S, N, W, L)
    sel = [torch.gather(t, 2, idx) for t in tbl]  # [S, N, W, L]; digit 0 picks the identity
    pad = cv.identity_like(px.new_zeros((S, NB * NC - N, W, L)))  # pad slots: the identity
    slots = [torch.cat([t, q], 1).reshape(S, NB, NC, W, L).unbind(2) for t, q in zip(sel, pad)]
    items = list(zip(*slots))  # NC slots of (x, y, z) [S, NB, W, L]
    while len(items) > 1:  # pairwise tree, left to right, an odd element carried up
        pairs = len(items) // 2
        left = [torch.stack([items[2 * i][j] for i in range(pairs)]) for j in range(3)]
        right = [torch.stack([items[2 * i + 1][j] for i in range(pairs)]) for j in range(3)]
        summed = list(zip(*(t.unbind(0) for t in add(left, right))))
        items = summed + items[2 * pairs:]
    root = items[0]
    acc = cv.identity_like(px.new_zeros((S, W, L)))
    for j in range(NB):
        acc = add(acc, tuple(t[:, j] for t in root))
    return tuple(a.movedim(1, 0).contiguous() for a in acc)


def msm_chunked_cuda(cv, P, k: torch.Tensor, nc: int):
    """Launch the chunked kernel on CUDA tensors: P coordinates [S, N, L]
    and k [S, N, Lk], all contiguous int32. Returns the window sums
    (x, y, z) [W, S, L]."""
    px = P[0]
    if px.device.type != "cuda":
        raise ValueError("msm_chunked_cuda: inputs must be CUDA tensors")
    if px.dim() != 3 or k.dim() != 3 or k.shape[:2] != px.shape[:2]:
        raise ValueError(f"msm_chunked_cuda: points {tuple(px.shape)} and scalars {tuple(k.shape)}")
    L, Lk = cv.fq.L, cv.fr.L
    for t in P:
        if t.shape != px.shape:
            raise ValueError("msm_chunked_cuda: coordinate shapes differ")
        _check(t, L, px.device, "msm_chunked")
    _check(k, Lk, px.device, "msm_chunked")
    S, N = px.shape[0], px.shape[1]
    W = num_windows(cv)
    NC = chunk_points(nc, N)
    if S == 0 or N == 0:
        return tuple(cv.identity_like(px.new_zeros((W, S, L))))
    out = [px.new_empty((W, S, L)) for _ in range(3)]
    tbl = torch.empty(S * N * (1 << WINDOW) * 3 * (L // 2), dtype=torch.int32, device=px.device)
    fn = build.function("msm_chunked.cu", "mp_msm_chunked", _CHUNKED_ARGS)
    stream = torch.cuda.current_stream(px.device).cuda_stream
    build.check(
        fn(L, W, a_case(cv), *(t.data_ptr() for t in P), k.data_ptr(), Lk, tbl.data_ptr(),
           *(o.data_ptr() for o in out), S, N, NC, curve_words(cv).ctypes.data, stream),
        "msm_chunked",
    )
    LAUNCHES["msm_chunked"] += 1
    return tuple(out)


def msm_chunked(cv, P, k: torch.Tensor, nc: int):
    """The window sums (x, y, z) [W, S, L] of sum_i k[s, i] * P[s, i],
    `chunk_points(nc, N)` points per step. CPU tensors take the plain
    version; CUDA tensors take the kernel."""
    if all(t.device.type == "cpu" for t in (*P, k)):
        return msm_chunked_plain(cv, P, k, nc)
    return msm_chunked_cuda(cv, tuple(t.contiguous() for t in P), k.contiguous(), nc)


def msm_lanes(cv, P, k: torch.Tensor, nc: int | None = None):
    """sum_i k[s, i] * P[s, i] per statement s, as an (x, y, z) tuple of
    [S, L] tensors. `nc` (default `config.get_config().msm_nc`) points per
    sequential step: 1 runs the per-statement kernel, above 1 the chunked
    kernel's window sums folded by the fold kernel (the TPU's
    `_msm_kernel_chunked`, whose emit mode `_kern_drop_fld` serves). CPU
    tensors take the plain versions; CUDA tensors take the kernels."""
    nc = get_config().msm_nc if nc is None else nc
    if nc > 1:
        return fold_windows(cv, msm_chunked(cv, P, k, nc), WINDOW)
    if all(t.device.type == "cpu" for t in (*P, k)):
        return msm_lanes_plain(cv, P, k)
    return msm_lanes_cuda(cv, tuple(t.contiguous() for t in P), k.contiguous())
