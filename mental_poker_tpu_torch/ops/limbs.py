"""Plain PyTorch limb arithmetic on [..., K] tensors of 16-bit limbs.

Shared by `ops/field.py` (add, sub, neg, compare) and the plain versions of
the kernels in `ops/cuda/`. Additions, borrows and carries work in the
caller's integer dtype (int32 holds the intermediates of add and sub: raw
limbs stay below 2^18); the schoolbook product needs int64 and is only called
on int64 tensors.

The plain versions run long chains of small calls (a point addition is a few
hundred tensor ops), so the code favours few ops per call: the product is one
outer product and one `index_add_`, and the position and index vectors are
cached per size and device.

Carries resolve flat, without a loop over limbs: shift-add rounds bring raw
limbs into the single-carry regime, then the 0/1 ripple settles in one
prefix pass. The carry into limb i is the carry generated at the last limb
below i that does not propagate (a running maximum over limb positions),
which gives the same bits as the Kogge-Stone (generate, propagate) scan of
`mental_poker_tpu/ops/field.py` in fewer tensor operations.
"""

from __future__ import annotations

import functools

import torch

from ..utils.rand import LIMB_BITS, MASK


def _add_carries_(y: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y[..., i] += c[..., i - 1] for i >= 1, in place on the fresh tensor y
    (a slice add costs fewer tensor ops than shifting c by padding)."""
    y[..., 1:] += c[..., :-1]
    return y


@functools.cache
def _positions(K: int, device: torch.device) -> torch.Tensor:
    return torch.arange(K, device=device)


@functools.cache
def _antidiag_index(K: int, device: torch.device) -> torch.Tensor:
    """Column i + j of entry (i, j) of a flattened [K, K] limb product."""
    i = torch.arange(K, device=device)
    return (i[:, None] + i[None, :]).flatten()


def _prefix_generate(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Inclusive (generate, propagate) prefix along the last axis:
    out[i] = carry (or borrow) out of limbs 0..i with none coming in, i.e.
    g at the last position j <= i where p[j] is false (0 if there is none).
    p: bool."""
    pos = _positions(g.shape[-1], g.device)
    last = torch.cummax(torch.where(p, -1, pos), dim=-1).values
    return torch.gather(g, -1, last.clamp(min=0)) * (last >= 0)


def carry(x: torch.Tensor, nout: int, rounds: int = 1, resolve: bool = True) -> torch.Tensor:
    """Raw limbs -> clean 16-bit limbs, `nout` of them. Carries out of limb
    nout-1 are dropped (reduction mod 2^(16 nout)). Each shift-add round
    takes raw limbs below 2^(16+k) to below 2^16 + 2^k: one round for raw
    limbs < 2^22, two for < 2^38, none for sums of two clean limbs; then a
    single 0/1 ripple is left. `resolve=False` skips the ripple and returns
    the limbs of the last round (the same value mod 2^(16 nout), each limb
    below 2^16 + 2^k)."""
    K = x.shape[-1]
    if K < nout:
        x = torch.cat([x, x.new_zeros(x.shape[:-1] + (nout - K,))], dim=-1)
    elif K > nout:
        x = x[..., :nout]
    for _ in range(rounds):
        x = _add_carries_(x & MASK, x >> LIMB_BITS)
    if not resolve:
        return x
    c = _prefix_generate(x >> LIMB_BITS, x == MASK)
    return _add_carries_(x & MASK, c) & MASK


def sub_limbs(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(16K) and the borrow out (1 where a < b)."""
    g = (a < b).to(a.dtype)
    bg = _prefix_generate(g, a == b)
    out = a + (1 << LIMB_BITS) - b
    out[..., 1:] -= bg[..., :-1]
    return out & MASK, bg[..., -1]


def cond_sub(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """a in [0, 2p) -> a mod p, branch-free."""
    d, brw = sub_limbs(a, p.expand_as(a))
    return torch.where((brw != 0)[..., None], a, d)


def add_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p for reduced inputs (2p < 2^(16K), so no carry is lost)."""
    return cond_sub(carry(a + b, a.shape[-1], rounds=0), p)


def sub_mod(a: torch.Tensor, b: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p for reduced inputs."""
    d, brw = sub_limbs(a, b)
    d2 = carry(d + p, d.shape[-1], rounds=0)
    return torch.where((brw != 0)[..., None], d2, d)


def raw_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook product of int64 limb vectors (batch dims broadcast): raw
    [..., 2K] limbs, limb k the sum of a_i b_j over i + j = k, each below
    K * 2^32 (< 2^37 for K <= 24; `carry` it with two rounds)."""
    K = a.shape[-1]
    op = (a[..., :, None] * b[..., None, :]).flatten(-2)  # [..., K*K], exact in int64
    out = op.new_zeros(op.shape[:-1] + (2 * K,))
    return out.index_add_(-1, _antidiag_index(K, a.device), op)
