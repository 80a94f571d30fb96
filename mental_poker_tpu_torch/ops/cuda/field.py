"""Montgomery multiply: the Hopper kernel and its plain PyTorch version.

Replaces `mental_poker_tpu/ops/pallas/field.py::_mont_mul_kernel` (entry
`mont_mul`, reached through `Field.mont_mul`). Source: `csrc/field.cu` with
the shared routines of `csrc/mont.cuh`.

- What it computes: a*b*R^-1 mod p for a batch of reduced Montgomery-form
  elements, R = 2^(16 L), L = 16 (Stark Fq/Fr) or 24 (BLS12-377 Fq).
- What bounds it on the H100: device memory. A Stark product moves 192
  bytes (two operands in, one out, 16-bit limbs held in 32-bit ints)
  against 136 32-bit word products (2*NW^2 + NW, NW = 8 words), 272
  multiply-add instructions: about 7x more time in memory than in
  arithmetic at the peak rates.
- What the design does about it: one thread per element, every
  intermediate in registers, 16-byte loads, one pass over memory. The TPU
  kernel's 16-bit limbs and Kogge-Stone carry scans exist because its
  vector unit has no 32x32->64 multiply; the GPU does, so the kernel packs
  limbs into 32-bit words and runs CIOS Montgomery multiplication on the
  carry flag (PTX multiply-adds with carry in and out, the even and odd
  words' products in two independent chains; `csrc/mont.cuh`). The output is
  the unique reduced value, so it equals the plain version limb for limb.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .. import limbs
from . import LAUNCHES, build

_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]


def words(x: int, nw: int) -> list:
    """Little-endian 32-bit words of a non-negative int."""
    return [(x >> (32 * j)) & 0xFFFFFFFF for j in range(nw)]


def field_words(fld) -> np.ndarray:
    """[p (NW words), n0 = -p^-1 mod 2^32] for the kernels' constants."""
    return _field_words(fld.p, fld.L)


@functools.cache
def _field_words(p: int, L: int) -> np.ndarray:
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return np.array(words(p, L // 2) + [n0], np.uint32)


def mont_mul_plain(fld, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Montgomery product (int64 arithmetic, any device):
    T = a*b; m = (T mod R) * N' mod R; S = T + m*p; out = S/R - p if >= p.
    Three schoolbook products and flat carry scans, no limb loop.

    Only S is carried to clean limbs. T mod R and m are left after their
    shift-add rounds (limbs below 2^16 + 2^11 and 2^16 + 2^7): the same
    values mod R, with m < R (1 + 2^-9). So S/R < a b / R + p (1 + 2^-9),
    below 2p whenever a b < (1 - 2^-9) R p, and one conditional subtraction
    gives the unique reduced value, the kernel's limb for limb. That holds
    for reduced operands (`Field` keeps p < R/2) and for the unreduced ones
    of `point_add_plain` (limbs below 2^19, a b <= 25 p^2, which it checks
    against the curve's p/R)."""
    a, b = torch.broadcast_tensors(a, b)
    L = fld.L
    dev = a.device
    p = fld.const("p_limbs", dev, torch.int64)
    nprime = fld.const("nprime_limbs", dev, torch.int64)
    T = limbs.raw_product(a.to(torch.int64), b.to(torch.int64))
    t_lo = limbs.carry(T[..., :L], L, rounds=2, resolve=False)
    m = limbs.carry(limbs.raw_product(t_lo, nprime), L, rounds=2, resolve=False)
    S = limbs.carry(T + limbs.raw_product(m, p), 2 * L, rounds=2)
    return limbs.cond_sub(S[..., L:], p).to(torch.int32)


def _check(t: torch.Tensor, L: int, device, name: str) -> None:
    if t.device != device:
        raise ValueError(f"{name}: operands on {t.device} and {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 limbs, got {t.dtype}")
    if t.shape[-1:] != (L,):
        raise ValueError(f"{name}: expected [..., {L}] limbs, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs contiguous, 16-byte-aligned limbs")


def mont_mul_cuda(fld, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on equal-shape CUDA tensors."""
    if a.device.type != "cuda":
        raise ValueError("mont_mul_cuda: operands must be CUDA tensors")
    if a.shape != b.shape:
        raise ValueError(f"mont_mul_cuda: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    L = fld.L
    for t in (a, b):
        _check(t, L, a.device, "mont_mul")
    out = torch.empty_like(a)
    n = a.numel() // L
    if n == 0:
        return out
    consts = field_words(fld)
    fn = build.function("field.cu", "mp_mont_mul", _ARGS)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    build.check(
        fn(L, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, consts.ctypes.data, stream),
        "mont_mul",
    )
    LAUNCHES["mont_mul"] += 1
    return out


def mont_mul(fld, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a*b*R^-1 mod p, broadcasting. CPU tensors take the plain version;
    CUDA tensors take the kernel (and raise if it cannot launch)."""
    a, b = torch.broadcast_tensors(a, b)
    if a.device.type == "cpu" and b.device.type == "cpu":
        return mont_mul_plain(fld, a, b)
    return mont_mul_cuda(fld, a.contiguous(), b.contiguous())
