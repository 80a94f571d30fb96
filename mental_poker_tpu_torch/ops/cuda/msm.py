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
  runs one block per statement with one thread per window, so the W window
  sums of a statement accumulate in parallel and only the fold is serial.
  `ops/msm.py::msm` splits the points of few-statement calls over several
  statements (the wide-split mapping) so that narrow calls still fill the
  card.

The plain version runs the same schedule (table entries t*P = (t-1)*P + P,
window sums in point order from the identity, MSB-first fold), so the two
agree limb for limb on the projective result.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, build
from .curve import curve_words, fold_windows_plain, point_add_plain
from .field import _check

_ARGS = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])

WINDOW = 4  # window bits; csrc/msm.cu's kC


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


def msm_lanes_plain(cv, P, k: torch.Tensor):
    """Plain PyTorch version of the kernel's schedule (any device).
    P: (x, y, z) coordinates [S, N, L]; k: canonical limbs [S, N, Lk]."""
    px, py, pz = P
    S, N, L = px.shape
    if N == 0:
        return cv.identity_like(px.new_zeros((S, L)))
    c = WINDOW
    W = num_windows(cv)
    T = 1 << c
    add = lambda A, B: point_add_plain(cv, A, B)
    # multiples tables [S, N, T, L] per coordinate
    ident = cv.identity_like(px)
    entries = [ident, (px, py, pz)]
    for _ in range(T - 2):
        entries.append(add(entries[-1], (px, py, pz)))
    tbl = [torch.stack([e[j] for e in entries], dim=2) for j in range(3)]
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
        fn(L, num_windows(cv), *(t.data_ptr() for t in P), k.data_ptr(), Lk, tbl.data_ptr(),
           *(o.data_ptr() for o in out), S, N, consts.ctypes.data, stream),
        "msm_lanes",
    )
    LAUNCHES["msm_lanes"] += 1
    return tuple(out)


def msm_lanes(cv, P, k: torch.Tensor):
    """sum_i k[s, i] * P[s, i] per statement s, as an (x, y, z) tuple of
    [S, L] tensors. CPU tensors take the plain version; CUDA tensors take
    the kernel."""
    if all(t.device.type == "cpu" for t in (*P, k)):
        return msm_lanes_plain(cv, P, k)
    return msm_lanes_cuda(cv, tuple(t.contiguous() for t in P), k.contiguous())
