"""Short-Weierstrass curve arithmetic (counterpart of `mental_poker_tpu/ops/curve.py`).

Points are homogeneous projective (X:Y:Z) triples of Montgomery-form limb
tensors [..., L]; the identity is (0:1:0) and `Z == 0` identifies it. They
combine with the complete Renes-Costello-Batina (2015) addition, one
branch-free formula for add, double and identity. `Curve.add` goes to the
Hopper kernel for CUDA tensors (`ops/cuda/curve.py`) and to its plain
version for CPU tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import host_curve
from ..utils.rand import LIMB_BITS
from . import field as field_mod
from .cuda import curve as cuda_curve
from .field import Field


class PointP(NamedTuple):
    """Projective point; each coordinate is int32 [..., L] Montgomery limbs."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor


def stack_points(points, dim: int = 0) -> PointP:
    return PointP(*(torch.stack([getattr(p, c) for p in points], dim=dim) for c in "xyz"))


def cat_points(points, dim: int = 0) -> PointP:
    return PointP(*(torch.cat([getattr(p, c) for p in points], dim=dim) for c in "xyz"))


def map_point(fn, P: PointP) -> PointP:
    """Apply a tensor function to every coordinate."""
    return PointP(fn(P.x), fn(P.y), fn(P.z))


class Curve:
    def __init__(self, host: host_curve.HostCurve, fq: Field, fr: Field):
        self.host = host
        self.fq = fq
        self.fr = fr
        self.name = host.name
        self.a_int = host.a % host.p
        self.a_mont = fq.from_int(host.a)
        self.b3_mont = fq.from_int(3 * host.b)
        self._consts: dict = {}

    def const(self, name: str, device) -> torch.Tensor:
        """`a_mont` / `b3_mont` as cached tensors on `device`."""
        device = torch.device(device)
        t = self._consts.get((name, device))
        if t is None:
            t = self.fq.tensor(getattr(self, name), device)
            self._consts[(name, device)] = t
        return t

    # ------------------------------------------------------------- building
    def identity(self, batch_shape=(), device="cuda") -> PointP:
        f = self.fq
        return PointP(f.zeros(batch_shape, device), f.ones(batch_shape, device), f.zeros(batch_shape, device))

    def identity_like(self, ref: torch.Tensor) -> PointP:
        """Identity with the batch shape and device of a [..., L] tensor."""
        return self.identity(ref.shape[:-1], ref.device)

    def from_affine(self, x, y, inf=None) -> PointP:
        """Affine Montgomery-limb coordinates -> projective; `inf`: bool[...]."""
        one = self.fq.const("one_mont", x.device).expand_as(x)
        if inf is None:
            return PointP(x, y, one.clone())
        infc = inf[..., None]
        zero = torch.zeros_like(x)
        return PointP(
            torch.where(infc, zero, x),
            torch.where(infc, one, y),
            torch.where(infc, zero, one),
        )

    def from_host_points(self, pts, device="cuda") -> PointP:
        """Host (x, y, inf) triples -> a batched projective point [len, L]."""
        f = self.fq
        xs = np.stack([f.from_int(0 if P[2] else P[0]) for P in pts])
        ys = np.stack([f.from_int(1 if P[2] else P[1]) for P in pts])
        inf = torch.as_tensor(np.array([bool(P[2]) for P in pts]), device=device)
        return self.from_affine(f.tensor(xs, device), f.tensor(ys, device), inf)

    def to_host_points(self, P: PointP) -> list:
        """Batched projective point -> list of host (x, y, inf) triples.

        The projective triples are copied to the host as they are and made
        affine there with Python ints: the same points as `to_affine` on the
        device, without its ~311-product Fermat inversion."""
        f = self.fq
        p = f.p
        xs, ys, zs = (c.reshape(-1, f.L).cpu().numpy() for c in P)
        out = []
        for xi, yi, zi in zip(xs, ys, zs):
            z = f.to_int(zi)
            if z == 0:
                out.append(self.host.identity)
                continue
            zinv = pow(z, -1, p)
            out.append((f.to_int(xi) * zinv % p, f.to_int(yi) * zinv % p, False))
        return out

    # ------------------------------------------------------------- core ops
    def is_identity(self, P: PointP):
        return self.fq.is_zero(P.z)

    def neg(self, P: PointP) -> PointP:
        return PointP(P.x, self.fq.neg(P.y), P.z)

    def add(self, P: PointP, Q: PointP) -> PointP:
        """Complete projective addition (RCB15 Algorithm 1, any a): the
        Hopper kernel on CUDA tensors, its plain version on CPU tensors."""
        return PointP(*cuda_curve.point_add(self, P, Q))

    def dbl(self, P: PointP) -> PointP:
        """Doubling = add(P, P) under the complete formulas."""
        return self.add(P, P)

    def select(self, cond, P: PointP, Q: PointP) -> PointP:
        """cond[...] ? P : Q, elementwise."""
        c = cond[..., None]
        return PointP(torch.where(c, P.x, Q.x), torch.where(c, P.y, Q.y), torch.where(c, P.z, Q.z))

    def eq(self, P: PointP, Q: PointP):
        """Projective equality (cross-multiplied), identity-aware."""
        f = self.fq
        x_eq = f.eq(f.mont_mul(P.x, Q.z), f.mont_mul(Q.x, P.z))
        y_eq = f.eq(f.mont_mul(P.y, Q.z), f.mont_mul(Q.y, P.z))
        pi, qi = self.is_identity(P), self.is_identity(Q)
        return (pi & qi) | (~pi & ~qi & x_eq & y_eq)

    # --------------------------------------------------------- scalar muls
    def multiples_table(self, P: PointP, c: int) -> PointP:
        """[identity, P, 2P, ..., (2^c - 1)P] stacked on axis -2."""
        rows = [self.identity_like(P.x), P]
        for _ in range((1 << c) - 2):
            rows.append(self.add(rows[-1], P))
        return stack_points(rows, dim=-2)

    def scalar_mul(self, k, P: PointP, c: int = 4) -> PointP:
        """k * P for canonical scalar limbs k [..., Lk] broadcast against P:
        a multiples table, then W = ceil(bits / c) windows of c doublings,
        one table lookup and one addition."""
        batch = torch.broadcast_shapes(k.shape[:-1], P.x.shape[:-1])
        L = P.x.shape[-1]
        P = map_point(lambda q: q.expand(batch + (L,)), P)
        k = k.expand(batch + k.shape[-1:])
        table = self.multiples_table(P, c)  # [..., 2^c, L]
        W = -(-self.fr.bits // c)
        per = LIMB_BITS // c
        acc = self.identity_like(P.x)
        for w in range(W - 1, -1, -1):
            for _ in range(c):
                acc = self.dbl(acc)
            dig = (k[..., w // per] >> ((w % per) * c)) & ((1 << c) - 1)
            idx = dig.long()[..., None, None].expand(batch + (1, L))
            acc = self.add(acc, map_point(lambda t: torch.gather(t, -2, idx)[..., 0, :], table))
        return acc

    def sum_points(self, P: PointP, axis: int = 0) -> PointP:
        """Sum along a batch axis: identity-padded halving tree, log2(n)
        batched additions."""
        P = map_point(lambda q: q.movedim(axis, 0), P)
        n = P.x.shape[0]
        if n == 0:
            return self.identity_like(P.x.new_zeros(P.x.shape[1:]))
        npow = 1 << (n - 1).bit_length()
        if npow != n:
            pad = self.identity_like(P.x.new_zeros((npow - n,) + P.x.shape[1:]))
            P = cat_points([P, pad])
        while P.x.shape[0] > 1:
            h = P.x.shape[0] // 2
            P = self.add(map_point(lambda q: q[:h], P), map_point(lambda q: q[h:], P))
        return map_point(lambda q: q[0], P)

    # ------------------------------------------------------------ to affine
    def to_affine(self, P: PointP):
        """-> (x, y, inf) with x, y Montgomery limbs; identity -> (0, 1, True)."""
        f = self.fq
        inf = self.is_identity(P)
        one = f.const("one_mont", P.z.device).expand_as(P.z)
        zinv = f.batch_inv(torch.where(inf[..., None], one, P.z))
        x = f.mont_mul(P.x, zinv)
        y = f.mont_mul(P.y, zinv)
        x = torch.where(inf[..., None], torch.zeros_like(x), x)
        y = torch.where(inf[..., None], one, y)
        return x, y, inf


@functools.cache
def stark_curve() -> Curve:
    return Curve(host_curve.STARK, field_mod.stark_fq(), field_mod.stark_fr())


@functools.cache
def bls12_377_g1() -> Curve:
    return Curve(host_curve.BLS12_377_G1, field_mod.bls12_377_fq(), field_mod.bls12_377_fr())
