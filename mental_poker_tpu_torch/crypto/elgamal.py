"""Batched ElGamal over the curve group (counterpart of
`mental_poker_tpu/crypto/elgamal.py`).

  keygen:   sk <- Fr,  pk = sk G
  encrypt:  E(m; r) = (r G, m + r pk)      decrypt: m = c1 - sk c0

Plaintexts ("cards") are curve points; a `Ciphertexts` holds a batch of
(c0, c1) projective pairs. Multiplications by the generator and by the
aggregate key go through their fixed-base window tables.
"""

from __future__ import annotations

from typing import NamedTuple

from ..ops import msm as msm_mod
from ..ops.curve import Curve, PointP
from ..ops.msm import FixedBaseTable
from ..utils.rand import GameRng
from .group import Base, base_mul


class Ciphertexts(NamedTuple):
    """Batched ElGamal ciphertexts (c0, c1), coordinates [..., L]."""

    c0: PointP
    c1: PointP


class ElGamalParams:
    """The encryption generator and its window table."""

    def __init__(self, cv: Curve, generator_host, c: int = 4, device="cuda", table=None):
        self.cv = cv
        self.generator = generator_host
        self.gen_table = FixedBaseTable(cv, generator_host, c, device, table)


def setup(cv: Curve, rng: GameRng, c: int = 4, device="cuda") -> ElGamalParams:
    """`ElGamal::setup`: a random generator (`mod.rs:110`)."""
    return ElGamalParams(cv, cv.host.rand_point(rng.rng), c, device)


def keygen(pp: ElGamalParams, rng: GameRng):
    """-> (pk host point, sk int) (`mod.rs:123-130`)."""
    sk = rng.scalar(pp.cv.host.order)
    return pp.cv.host.mul(sk, pp.generator), sk


def encrypt(pp: ElGamalParams, pk: Base, msgs: PointP, r_limbs) -> Ciphertexts:
    """E(m; r) = (r G, m + r pk), batched over canonical r [..., Lk]."""
    cv = pp.cv
    return Ciphertexts(pp.gen_table.mul(r_limbs), cv.add(msgs, base_mul(cv, pk, r_limbs)))


def encrypt_zero(pp: ElGamalParams, pk: Base, r_limbs) -> Ciphertexts:
    """E(0; r) = (r G, r pk), batched over canonical r [..., Lk] (the
    remask delta, `remasking.rs:15-19`)."""
    return Ciphertexts(pp.gen_table.mul(r_limbs), base_mul(pp.cv, pk, r_limbs))


def cipher_add(cv: Curve, a: Ciphertexts, b: Ciphertexts) -> Ciphertexts:
    return Ciphertexts(cv.add(a.c0, b.c0), cv.add(a.c1, b.c1))


def cipher_sub(cv: Curve, a: Ciphertexts, b: Ciphertexts) -> Ciphertexts:
    return Ciphertexts(cv.add(a.c0, cv.neg(b.c0)), cv.add(a.c1, cv.neg(b.c1)))


def cipher_neg(cv: Curve, a: Ciphertexts) -> Ciphertexts:
    return Ciphertexts(cv.neg(a.c0), cv.neg(a.c1))


def cipher_scalar_mul(cv: Curve, a: Ciphertexts, k_limbs) -> Ciphertexts:
    """a^k elementwise over the batch."""
    return Ciphertexts(cv.scalar_mul(k_limbs, a.c0), cv.scalar_mul(k_limbs, a.c1))


def cipher_identity(cv: Curve, batch_shape=(), device="cuda") -> Ciphertexts:
    return Ciphertexts(cv.identity(batch_shape, device), cv.identity(batch_shape, device))


def cipher_select(cv: Curve, cond, a: Ciphertexts, b: Ciphertexts) -> Ciphertexts:
    return Ciphertexts(cv.select(cond, a.c0, b.c0), cv.select(cond, a.c1, b.c1))


def cipher_sum(cv: Curve, a: Ciphertexts, axis: int) -> Ciphertexts:
    """Sum (product in multiplicative notation) of ciphertexts along a batch
    axis."""
    ax = axis % (a.c0.x.dim() - 1)
    return Ciphertexts(cv.sum_points(a.c0, axis=ax), cv.sum_points(a.c1, axis=ax))


def cipher_msm(cv: Curve, a: Ciphertexts, scalars) -> Ciphertexts:
    """prod_i a_i^{s_i} along the second-to-last point axis (two MSMs)."""
    return Ciphertexts(msm_mod.msm(cv, a.c0, scalars), msm_mod.msm(cv, a.c1, scalars))


def rand_ciphertexts(cv: Curve, rng: GameRng, n: int, device="cuda") -> Ciphertexts:
    """Uniformly random ciphertexts (`MaskedCard::rand`)."""
    pts0 = [cv.host.rand_point(rng.rng) for _ in range(n)]
    pts1 = [cv.host.rand_point(rng.rng) for _ in range(n)]
    return Ciphertexts(cv.from_host_points(pts0, device), cv.from_host_points(pts1, device))


def rand_plaintexts(cv: Curve, rng: GameRng, n: int, device="cuda") -> PointP:
    """Uniformly random plaintexts (`Card::rand`)."""
    return cv.from_host_points([cv.host.rand_point(rng.rng) for _ in range(n)], device)
