"""Fixed-limb prime-field arithmetic (counterpart of `mental_poker_tpu/ops/field.py`).

A field element is an int32 tensor [..., L] of little-endian 16-bit limbs
(see the package docstring), kept in Montgomery form x*R mod p with
R = 2^(16 L). `mont_mul` goes to the Hopper kernel for CUDA tensors
(`ops/cuda/field.py`) and to its plain version for CPU tensors; every
other method is plain PyTorch on whatever device its inputs live on.

Instances: Stark Fq/Fr (the reference's primary curve) and BLS12-377 Fq/Fr.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.rand import LIMB_BITS, MASK, int_to_limbs, limbs_to_int
from . import limbs
from .cuda import field as cuda_field

LIMB_DTYPE = torch.int32


class Field:
    """GF(p) with limb arithmetic on [..., L] int32 tensors.

    Values passed to `mont_mul`/`add`/`sub` must be reduced (< p) and in
    Montgomery form unless noted. Batch dimensions broadcast.
    """

    def __init__(self, modulus: int, name: str = "F", nlimbs: int | None = None):
        self.p = modulus
        self.name = name
        bits = modulus.bit_length()
        L = nlimbs if nlimbs is not None else -(-bits // LIMB_BITS)
        if 2 * modulus >= 1 << (LIMB_BITS * L):  # a + b (< 2p) must fit
            L += 1
        self.L = L
        self.bits = bits
        self.R = 1 << (LIMB_BITS * L)
        self.r_mod_p = self.R % modulus
        self.p_limbs = int_to_limbs(modulus, L)
        self.r2_limbs = int_to_limbs(self.R * self.R % modulus, L)
        self.one_mont = int_to_limbs(self.r_mod_p, L)
        self.raw_one = int_to_limbs(1, L)
        self.nprime_limbs = int_to_limbs((-pow(modulus, -1, self.R)) % self.R, L)
        self._consts: dict = {}

    # ---------------------------------------------------------------- host
    def from_int(self, x: int) -> np.ndarray:
        """Canonical int -> Montgomery-form limbs (host, uint32)."""
        return int_to_limbs((x % self.p) * self.R % self.p, self.L)

    def to_int(self, a) -> int:
        """Montgomery-form limbs (host array or tensor) -> canonical int."""
        return limbs_to_int(_np(a)) * pow(self.R, -1, self.p) % self.p

    def from_int_array(self, xs) -> np.ndarray:
        return np.stack([self.from_int(int(x)) for x in xs])

    def tensor(self, host, device) -> torch.Tensor:
        """Host limb array -> int32 tensor on `device`."""
        return torch.as_tensor(np.asarray(host).astype(np.int32), device=device)

    def const(self, name: str, device, dtype=LIMB_DTYPE) -> torch.Tensor:
        """A host constant (`p_limbs`, `one_mont`, ...) as a cached tensor."""
        device = torch.device(device)
        key = (name, device, dtype)
        t = self._consts.get(key)
        if t is None:
            t = self.tensor(getattr(self, name), device).to(dtype)
            self._consts[key] = t
        return t

    # -------------------------------------------------------------- device
    def zeros(self, batch_shape=(), device="cuda") -> torch.Tensor:
        return torch.zeros(tuple(batch_shape) + (self.L,), dtype=LIMB_DTYPE, device=device)

    def ones(self, batch_shape=(), device="cuda") -> torch.Tensor:
        one = self.const("one_mont", device)
        return one.expand(tuple(batch_shape) + (self.L,)).clone()

    def add(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return limbs.add_mod(a, b, self.const("p_limbs", a.device))

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return limbs.sub_mod(a, b, self.const("p_limbs", a.device))

    def neg(self, a):
        """-a mod p (0 -> 0)."""
        d, _ = limbs.sub_limbs(self.const("p_limbs", a.device).expand_as(a), a)
        return torch.where(self.is_zero(a)[..., None], a, d)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def eq(self, a, b):
        return (a == b).all(dim=-1)

    def mont_mul(self, a, b):
        """a*b*R^-1 mod p: the Hopper kernel on CUDA tensors, its plain
        version on CPU tensors (`ops/cuda/field.py`)."""
        return cuda_field.mont_mul(self, a, b)

    def sqr(self, a):
        return self.mont_mul(a, a)

    def to_mont(self, a):
        """Canonical limbs -> Montgomery form."""
        return self.mont_mul(a, self.const("r2_limbs", a.device))

    def from_mont(self, a):
        """Montgomery form -> canonical limbs."""
        return self.mont_mul(a, self.const("raw_one", a.device))

    def pow_const(self, a, e: int):
        """a^e for a static exponent, MSB first: 4-bit fixed windows over a
        table a^1..a^15 for long exponents (p - 2 for Stark Fq: 311 products
        instead of 444 bit by bit), square-and-multiply for short ones."""
        if e == 0:
            return self.const("one_mont", a.device).expand_as(a).clone()
        if e.bit_length() <= 16:
            acc = a
            for bit in bin(e)[3:]:
                acc = self.mont_mul(acc, acc)
                if bit == "1":
                    acc = self.mont_mul(acc, a)
            return acc
        table = [None, a]
        for _ in range(14):
            table.append(self.mont_mul(table[-1], a))
        digits = [(e >> s) & 15 for s in range(0, e.bit_length(), 4)]
        acc = table[digits[-1]]
        for d in reversed(digits[:-1]):
            for _ in range(4):
                acc = self.mont_mul(acc, acc)
            if d:
                acc = self.mont_mul(acc, table[d])
        return acc

    def inv(self, a):
        """a^-1 via Fermat (a^(p-2)); maps 0 -> 0."""
        return self.pow_const(a, self.p - 2)

    def batch_inv(self, a):
        """Inverse of every element; zeros map to zero.

        One Fermat exponentiation over the whole batch: the same values as
        Montgomery's trick, with no sequential scan over the batch (on the
        card a scan costs one launch per element, the exponentiation ~311
        launches whatever the batch)."""
        return self.inv(a)

    def select(self, cond, a, b):
        """cond ? a : b over batch dims."""
        return torch.where(cond[..., None], a, b)

    def prefix_prod(self, a, axis: int):
        """Inclusive prefix product along `axis` (a batch axis, not the limb
        axis): Hillis-Steele doubling, log2(n) batched `mont_mul`s."""
        a = a.movedim(axis, 0)
        n = a.shape[0]
        d = 1
        while d < n:
            a = torch.cat([a[:d], self.mont_mul(a[d:], a[: n - d])], dim=0)
            d *= 2
        return a.movedim(0, axis)

    # ------------------------------------------------- vector algebra (mont)
    def _tree(self, a, axis, op, pad_name):
        a = a.movedim(axis, 0)
        n = a.shape[0]
        if n == 0:
            return self.const(pad_name, a.device).expand(a.shape[1:]).clone()
        npow = 1 << (n - 1).bit_length()
        if npow != n:
            pad = self.const(pad_name, a.device).expand((npow - n,) + a.shape[1:])
            a = torch.cat([a, pad], dim=0)
        while a.shape[0] > 1:
            h = a.shape[0] // 2
            a = op(a[:h], a[h:])
        return a[0]

    def sum_mod(self, a, axis: int = -2):
        """Modular sum along a batch axis: halving tree of `add`."""
        return self._tree(a, axis, self.add, "zero_limbs")

    def prod_mod(self, a, axis: int = -2):
        """Modular product (Montgomery form) along a batch axis."""
        return self._tree(a, axis, self.mont_mul, "one_mont")

    @property
    def zero_limbs(self):
        return np.zeros((self.L,), np.uint32)

    def powers(self, x, k: int, start: int = 1):
        """[x^start, ..., x^(start+k-1)] stacked on a new axis -2 (Montgomery
        form). Doubling: log2(k) batched `mont_mul`s."""
        if k == 0:
            return x.new_zeros(x.shape[:-1] + (0, self.L))
        pw = x[..., None, :]  # x^1
        xp = x  # x^(len(pw))
        while pw.shape[-2] < k:
            pw = torch.cat([pw, self.mont_mul(pw, xp[..., None, :])], dim=-2)
            xp = self.mont_mul(xp, xp)
        pw = pw[..., :k, :]
        if start == 1:
            return pw
        one = self.const("one_mont", x.device).expand(x.shape[:-1] + (1, self.L))
        if start == 0:
            return torch.cat([one, pw[..., : k - 1, :]], dim=-2)
        shift = self.pow_const(x, start - 1)
        return self.mont_mul(pw, shift[..., None, :])

    def dot_mod(self, a, b, axis: int = -2):
        """<a, b> mod p (Montgomery form) along a batch axis."""
        return self.sum_mod(self.mont_mul(a, b), axis=axis)

    def small_int_limbs(self, values, device) -> torch.Tensor:
        """Small non-negative ints -> canonical int32 [..., L] limbs."""
        vals = np.asarray(values, dtype=np.int64)
        out = np.zeros(vals.shape + (self.L,), np.int32)
        rem = vals.copy()
        for i in range(self.L):
            out[..., i] = rem & MASK
            rem >>= LIMB_BITS
        return torch.as_tensor(out, device=device)

    def canonical_lt(self, a, b):
        """a < b comparing raw limb values."""
        a, b = torch.broadcast_tensors(a, b)
        _, brw = limbs.sub_limbs(a, b)
        return brw != 0

    def __repr__(self):
        return f"Field({self.name}, {self.bits} bits, L={self.L})"


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# Stark curve fields (the reference's primary curve, `tests.rs:16-17`).
STARK_P = 2**251 + 17 * 2**192 + 1
STARK_R = 0x0800000000000010FFFFFFFFFFFFFFFFB781126DCAE7B2321E66A241ADC64D2F

# BLS12-377 (the reference's benchmark curve, `parameter_selection.rs:25`).
BLS12_377_P = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
BLS12_377_R = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001


@functools.cache
def stark_fq() -> Field:
    return Field(STARK_P, "stark_fq")


@functools.cache
def stark_fr() -> Field:
    return Field(STARK_R, "stark_fr")


@functools.cache
def bls12_377_fq() -> Field:
    return Field(BLS12_377_P, "bls377_fq")


@functools.cache
def bls12_377_fr() -> Field:
    return Field(BLS12_377_R, "bls377_fr")
