"""Complete point addition and the window fold: the Hopper kernels and their
plain PyTorch versions (the fold is described at `fold_windows`).

Replaces `mental_poker_tpu/ops/pallas/curve.py::_add_kernel` (body
`_rcb_add`, entry `point_add`, reached through `Curve.add`). Source:
`csrc/curve.cu` with the shared routines of `csrc/mont.cuh`.

- What it computes: P + Q for a batch of projective points by Renes,
  Costello and Batina (2015), Algorithm 1, complete for any a, so the
  identity and P + P need no branch (doubling is add(P, P)).
- What bounds it on the H100: memory and arithmetic nearly balance. A
  Stark addition is 14 Montgomery products (12 general, 2 by 3b; the 3
  products by a are specialised away for a = 0 and a = 1, see `a_case`) of
  136 word products each, 3,808 multiply-add instructions, against 576
  bytes of device memory (six coordinates in, three out); at the peak rates
  the multiply-adds take about 1.3x longer.
- What the design does about it: one thread per addition with the whole
  formula in registers, so device memory sees only the inputs and outputs;
  the Montgomery product runs on the carry flag (`csrc/mont.cuh`). The
  schedule is the JAX kernel's, product for product, so the projective
  result equals the plain version limb for limb.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.rand import int_to_limbs
from .. import limbs
from . import LAUNCHES, build
from .field import _check, _field_words, mont_mul_plain, words

_ARGS = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]

A_ZERO, A_ONE, A_GENERAL = 0, 1, 2  # csrc/mont.cuh's kAZero, kAOne, kAGeneral


def a_case(cv) -> int:
    """The kernels' compile-time case for the curve's a: `A_ZERO` (products
    by a are 0), `A_ONE` (they are copies) or `A_GENERAL`. Chosen from a
    itself, whatever the limb count; exact, since mont_mul(x, 0) = 0 and
    mont_mul(x, R mod p) = x for reduced x."""
    return {0: A_ZERO, 1: A_ONE}.get(cv.a_int, A_GENERAL)


def curve_words(cv) -> np.ndarray:
    """[p, n0, a, 3b, one] as 32-bit words for the kernels' constants."""
    return _curve_words(cv.fq.p, cv.fq.L, cv.a_int, cv.host.b % cv.fq.p)


@functools.cache
def _curve_words(p: int, L: int, a: int, b: int) -> np.ndarray:
    nw = L // 2
    R = 1 << (16 * L)
    mont = lambda v: words(v % p * R % p, nw)
    fw = list(_field_words(p, L))
    return np.array(fw + mont(a) + mont(3 * b) + mont(1), np.uint32)


@functools.cache
def _lazy_offset(p: int, L: int, device: torch.device) -> torch.Tensor:
    """4p as L limbs with every limb but the top at least 2^18 - 4 (borrows
    moved up: the same value), so u - v + 4p has no negative limb when v's
    limbs are below 2^17 and its top limb at most twice p's. Raises unless
    the lazy bounds of `point_add_plain` hold for this p (products of
    operands below 5p reduce exactly: 25 p < (1 - 2^-9) R)."""
    R = 1 << (16 * L)
    if 4 * p >= R or 25 * p * 512 >= 511 * R:
        raise ValueError("point_add_plain: lazy reduction bounds do not hold for this field")
    c = [int(x) for x in int_to_limbs(4 * p, L)]
    if c[-1] - 4 < 2 * int(int_to_limbs(p, L)[-1]):
        raise ValueError("point_add_plain: lazy reduction bounds do not hold for this field")
    q = [c[0] + (1 << 18)] + [x + (1 << 18) - 4 for x in c[1:-1]] + [c[-1] - 4]
    return torch.tensor(q, dtype=torch.int32, device=device)


def point_add_plain(cv, P, Q):
    """Plain PyTorch RCB15 addition (any device). The 17 products and the
    additions are regrouped by dependency depth into 3 batched products and
    a few batched additions over operands stacked on a new leading axis.

    Sums and differences that only feed products stay unreduced (u + v,
    and u - v + 4p through `_lazy_offset`): every operand of a product is
    then below 5p with limbs below 2^19, which `mont_mul_plain` reduces
    exactly. The three outputs are reduced sums, so the result is the
    kernel's limb for limb."""
    fq = cv.fq
    X1, Y1, Z1, X2, Y2, Z2 = torch.broadcast_tensors(*P, *Q)
    dev = X1.device
    p = fq.const("p_limbs", dev)
    off = _lazy_offset(fq.p, fq.L, dev)
    a = cv.const("a_mont", dev).expand_as(X1)
    b3 = cv.const("b3_mont", dev).expand_as(X1)
    mul = lambda u, v: mont_mul_plain(fq, u, v)
    lsub = lambda u, v: u - v + off  # < 5p for u < p, v < 2p
    st = lambda *xs: torch.stack(xs, dim=0)

    sums = st(X1, X2, X1, X2, Y1, Y2) + st(Y1, Y2, Z1, Z2, Z1, Z2)  # < 2p each
    t0, t1, t2, p3, p4, p5 = mul(
        st(X1, Y1, Z1, sums[0], sums[2], sums[4]),
        st(X2, Y2, Z2, sums[1], sums[3], sums[5]),
    )
    ss = st(t0, t0, t1) + st(t1, t2, t2)  # t0+t1, t0+t2, t1+t2
    t3, t4, t5, t0mt2 = lsub(st(p3, p4, p5, t0), st(ss[0], ss[1], ss[2], t2))
    u0, u1, u2, u3, u4 = mul(st(a, b3, a, b3, a), st(t4, t2, t2, t4, t0mt2))
    z3p, t4b = st(u1, u3) + st(u0, u4)  # < 2p
    t1b = 3 * t0 + u2  # < 4p
    z3a = t1 + z3p  # < 3p
    x3a = lsub(t1, z3p)
    v = mul(st(x3a, t1b, t5, x3a, t3, t5), st(z3a, t4b, t4b, t3, t1b, z3a))
    Y3, Z3 = limbs.add_mod(st(v[0], v[5]), st(v[1], v[4]), p)
    X3 = limbs.sub_mod(v[3], v[2], p)
    return X3, Y3, Z3


def point_add_cuda(cv, P, Q):
    """Launch the kernel on six equal-shape CUDA coordinate tensors."""
    coords = list(P) + list(Q)
    x1 = coords[0]
    if x1.device.type != "cuda":
        raise ValueError("point_add_cuda: coordinates must be CUDA tensors")
    L = cv.fq.L
    for t in coords:
        if t.shape != x1.shape:
            raise ValueError(f"point_add_cuda: shapes {tuple(t.shape)} and {tuple(x1.shape)}")
        _check(t, L, x1.device, "point_add")
    out = [torch.empty_like(x1) for _ in range(3)]
    n = x1.numel() // L
    if n == 0:
        return tuple(out)
    consts = curve_words(cv)
    fn = build.function("curve.cu", "mp_point_add", _ARGS)
    stream = torch.cuda.current_stream(x1.device).cuda_stream
    build.check(
        fn(L, a_case(cv), *(t.data_ptr() for t in coords), *(o.data_ptr() for o in out), n,
           consts.ctypes.data, stream),
        "point_add",
    )
    LAUNCHES["point_add"] += 1
    return tuple(out)


def point_add(cv, P, Q):
    """P + Q over broadcast batch shapes, as an (x, y, z) tuple. CPU
    tensors take the plain version; CUDA tensors take the kernel."""
    coords = torch.broadcast_tensors(*P, *Q)
    if all(t.device.type == "cpu" for t in coords):
        return point_add_plain(cv, coords[:3], coords[3:])
    coords = [t.contiguous() for t in coords]
    return point_add_cuda(cv, coords[:3], coords[3:])


# ---------------------------------------------------------------------------
# Window fold (replaces `mental_poker_tpu/ops/pallas/curve.py::_fold_kernel`,
# builder `_build_fold`, entry `fold_windows`, reached through the gather MSM
# engine `ops/msm.py::msm_gather`).
#
# - What it computes: sum_w 2^(c w) * S_w over W window sums (window 0 least
#   significant), by the TPU kernel's Horner schedule: from the identity, for
#   w = W-1 down to 0, c doublings as add(acc, acc), then add(acc, S_w).
# - What bounds it on the H100: W * (c + 1) dependent additions per statement
#   (315 for Stark, 320 for BLS12-377). For the few-statement calls of the
#   host Bayer-Groth argument the latency of that chain sets the time, not
#   the card's rate; at S statements the operations bound is S times the
#   chain's Montgomery products. Window w must be doubled c*w times, so the
#   chain of doublings cannot be shortened by reordering.
# - What the design does about it: it cuts the latency of each addition.
#   A lane group of eight threads takes one statement and spreads the
#   products of each of RCB15's three layers over its lanes, so three
#   products lie on the critical path of an addition instead of 14-17
#   (`csrc/fold.cuh::group_fold`, shared with msm.cu's window/fold kernel).
#   One warp per block, four statements; the block stages its statements'
#   window sums in shared memory, so device memory sees each window sum and
#   each result once. The window (c = 4) and W are built in per curve, as in
#   msm.cu; other shapes raise on the card.
# ---------------------------------------------------------------------------

FOLD_WINDOW = 4  # csrc/curve.cu's kFoldC
FOLD_W = {16: 63, 24: 64}  # windows built in per limb count (Stark, BLS12-377)
_FOLD_ARGS = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def fold_windows_plain(cv, S, c: int):
    """Plain PyTorch fold (any device, any c). S: (x, y, z) [W, ..., L]."""
    sx, sy, sz = S
    acc = tuple(cv.identity_like(sx.new_zeros(sx.shape[1:])))
    for w in range(sx.shape[0] - 1, -1, -1):
        for _ in range(c):
            acc = point_add_plain(cv, acc, acc)
        acc = point_add_plain(cv, acc, (sx[w], sy[w], sz[w]))
    return acc


def fold_windows_cuda(cv, S, c: int):
    """Launch the kernel on CUDA window sums (x, y, z) [W, ..., L], all
    contiguous int32 of one shape."""
    sx = S[0]
    if sx.device.type != "cuda":
        raise ValueError("fold_windows_cuda: window sums must be CUDA tensors")
    L = cv.fq.L
    W = sx.shape[0] if sx.dim() >= 2 else 0
    if c != FOLD_WINDOW or W != FOLD_W.get(L):
        raise ValueError(
            f"fold_windows_cuda: the kernel is built for c={FOLD_WINDOW}, W={FOLD_W.get(L)} "
            f"at L={L}; got c={c}, W={W}"
        )
    for t in S:
        if t.shape != sx.shape:
            raise ValueError("fold_windows_cuda: coordinate shapes differ")
        _check(t, L, sx.device, "fold_windows")
    out = [sx.new_empty(sx.shape[1:]) for _ in range(3)]
    n = out[0].numel() // L
    if n == 0:
        return tuple(out)
    fn = build.function("curve.cu", "mp_fold_windows", _FOLD_ARGS)
    stream = torch.cuda.current_stream(sx.device).cuda_stream
    build.check(
        fn(L, W, a_case(cv), *(t.data_ptr() for t in S), *(o.data_ptr() for o in out), n,
           curve_words(cv).ctypes.data, stream),
        "fold_windows",
    )
    LAUNCHES["fold_windows"] += 1
    return tuple(out)


def fold_windows(cv, S, c: int):
    """sum_w 2^(c w) * S_w for window sums S (x, y, z) [W, ..., L], as an
    (x, y, z) tuple of [..., L]. CPU tensors take the plain version; CUDA
    tensors take the kernel."""
    if all(t.device.type == "cpu" for t in S):
        return fold_windows_plain(cv, S, c)
    return fold_windows_cuda(cv, tuple(t.contiguous() for t in S), c)
