"""Batched sigma protocols: Schnorr identification and Chaum-Pedersen
discrete-log equality (counterpart of `mental_poker_tpu/crypto/sigma.py`).

The point work (commitments, verification equations) runs batched over [B]
statements on the bases' device; challenges come from B independent host
Fiat-Shamir transcripts; responses are host int arithmetic.

Transcript schedule (the JAX package's):
  Schnorr  : absorb( bytes(g) || bytes(pk) || bytes(t) );        c; s = k + c*sk
             verify: s*g == t + c*pk
  ChaumPed : absorb( bytes(g)||bytes(h)||bytes(a)||bytes(b)||
                     bytes(t_g)||bytes(t_h) );                   c; s = k + c*w
             verify: s*g == t_g + c*a  and  s*h == t_h + c*b
Point bytes use the arkworks `ToBytes` layout (serialize.py).

Verification runs every variable-base product of a batch (c*a, c*b, and s*g
or s*h where a base is a batched point) as one `scalar_mul` over the stacked
statements: one chain of point additions instead of two or three. The points
a call absorbs go to the host together (`group.host_points`): one copy per
call instead of one per point.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.curve import Curve, PointP, map_point, stack_points
from ..ops.msm import FixedBaseTable
from ..utils.rand import GameRng
from . import serialize as ser
from .errors import CHAUM_PEDERSEN, SCHNORR, ProofVerificationError
from .group import Base, base_device, base_mul, base_point, concat_blobs, host_point_bytes, host_points, points_to_bytes, scalars_to_limbs
from .transcript import TranscriptBatch


def batch_muls(cv: Curve, pairs) -> list:
    """[(k [..., Lk], P [...]), ...] of one batch shape -> [k_i * P_i], as one
    `scalar_mul` over the pairs stacked on a new leading axis."""
    shape = pairs[0][0].shape[:-1]
    k = torch.stack([k for k, _ in pairs])
    P = stack_points([map_point(lambda q: q.expand(shape + q.shape[-1:]), p) for _, p in pairs])
    out = cv.scalar_mul(k, P)
    return [map_point(lambda q: q[i], out) for i in range(len(pairs))]


def _unflat(cv: Curve, hosts, shape, device) -> PointP:
    P = cv.from_host_points(hosts, device)
    return map_point(lambda q: q.reshape(tuple(shape) + q.shape[-1:]), P)


@dataclasses.dataclass
class SchnorrProof:
    """(t, s): t = k*g commitments (host points), s = k + c*sk responses."""

    commit: list  # [B] host points
    response: list  # [B] Python ints

    def serialize(self, cv: Curve) -> list[bytes]:
        return [
            ser.point_to_bytes_compressed(t, cv.host) + ser.scalar_to_bytes(s, cv.host.order.bit_length())
            for t, s in zip(self.commit, self.response)
        ]


def schnorr_prove(cv: Curve, gen: Base, pk_hosts: list, sk_ints: list, ts: TranscriptBatch, rng: GameRng) -> SchnorrProof:
    order = cv.host.order
    dev = base_device(gen)
    ks = [rng.scalar(order) for _ in range(len(sk_ints))]
    t_dev = base_mul(cv, gen, scalars_to_limbs(ks, cv.fr.L, dev))
    g_hosts, t_hosts = host_points(cv, base_point(cv, gen, ()), t_dev)
    g_bytes = [host_point_bytes(cv, g) for g in g_hosts]
    ts.absorb(
        concat_blobs(
            g_bytes,
            [host_point_bytes(cv, pk) for pk in pk_hosts],
            [host_point_bytes(cv, t) for t in t_hosts],
        )
    )
    cs = ts.sample_field(order)
    ss = [(k + c * sk) % order for k, c, sk in zip(ks, cs, sk_ints)]
    return SchnorrProof(t_hosts, ss)


def schnorr_verify(cv: Curve, gen: Base, pk_hosts: list, proof: SchnorrProof, ts: TranscriptBatch) -> None:
    order = cv.host.order
    dev = base_device(gen)
    g_bytes = points_to_bytes(cv, base_point(cv, gen, ()))
    ts.absorb(
        concat_blobs(
            g_bytes,
            [host_point_bytes(cv, pk) for pk in pk_hosts],
            [host_point_bytes(cv, t) for t in proof.commit],
        )
    )
    cs = ts.sample_field(order)
    L = cv.fr.L
    lhs = base_mul(cv, gen, scalars_to_limbs(proof.response, L, dev))
    pk_dev = cv.from_host_points(pk_hosts, dev)
    rhs = cv.add(cv.from_host_points(proof.commit, dev), cv.scalar_mul(scalars_to_limbs(cs, L, dev), pk_dev))
    if not bool(cv.eq(lhs, rhs).all()):
        raise ProofVerificationError(SCHNORR)


@dataclasses.dataclass
class ChaumPedersenProof:
    """(t_g, t_h, s) per statement; `shape` is the statements' batch shape."""

    t_g: list  # [B] host points
    t_h: list  # [B] host points
    response: list  # [B] Python ints
    shape: tuple = ()

    def serialize(self, cv: Curve) -> list[bytes]:
        sb = cv.host.order.bit_length()
        return [
            ser.point_to_bytes_compressed(tg, cv.host) + ser.point_to_bytes_compressed(th, cv.host) + ser.scalar_to_bytes(s, sb)
            for tg, th, s in zip(self.t_g, self.t_h, self.response)
        ]


def cp_prove(
    cv: Curve,
    base_g: Base,
    base_h: Base,
    stmt_a: PointP,
    stmt_b: PointP,
    witnesses: list,
    ts: TranscriptBatch,
    rng: GameRng,
) -> ChaumPedersenProof:
    """Prove a = w*g, b = w*h for each batched statement (`stmt_a`/`stmt_b`
    of any batch shape, flattened C-order to match `ts` and `witnesses`)."""
    shape = tuple(stmt_a.x.shape[:-1])
    ks = cp_nonces(cv, shape, rng)
    k_limbs = scalars_to_limbs(ks, cv.fr.L, stmt_a.x.device, shape)
    t_g = base_mul(cv, base_g, k_limbs)
    t_h = base_mul(cv, base_h, k_limbs)
    return cp_respond(cv, base_g, base_h, stmt_a, stmt_b, t_g, t_h, ks, witnesses, ts)


def cp_nonces(cv: Curve, shape, rng: GameRng) -> list:
    """The prover's nonces k, one per statement, drawn as `cp_prove` draws
    them."""
    B = 1
    for d in shape:
        B *= d
    return [rng.scalar(cv.host.order) for _ in range(B)]


def cp_respond(cv: Curve, base_g: Base, base_h: Base, stmt_a: PointP, stmt_b: PointP, t_g: PointP, t_h: PointP, ks: list, witnesses: list, ts: TranscriptBatch) -> ChaumPedersenProof:
    """The rest of `cp_prove` once the commitments t_g = k*g and t_h = k*h
    are made (a caller may make them in one batch with other products)."""
    order = cv.host.order
    shape = tuple(stmt_a.x.shape[:-1])
    if not len(witnesses) == len(ks) == len(ts):
        raise ValueError(f"{len(witnesses)} witnesses and {len(ts)} transcripts for {len(ks)} statements")
    hosts = host_points(
        cv, base_point(cv, base_g, shape), base_point(cv, base_h, shape), stmt_a, stmt_b, t_g, t_h
    )
    ts.absorb(concat_blobs(*([host_point_bytes(cv, p) for p in group] for group in hosts)))
    cs = ts.sample_field(order)
    ss = [(k + c * w) % order for k, c, w in zip(ks, cs, witnesses)]
    return ChaumPedersenProof(hosts[4], hosts[5], ss, shape)


def cp_verify(
    cv: Curve,
    base_g: Base,
    base_h: Base,
    stmt_a: PointP,
    stmt_b: PointP,
    proof: ChaumPedersenProof,
    ts: TranscriptBatch,
) -> None:
    order = cv.host.order
    shape = tuple(stmt_a.x.shape[:-1])
    dev = stmt_a.x.device
    hosts = host_points(cv, base_point(cv, base_g, shape), base_point(cv, base_h, shape), stmt_a, stmt_b)
    hosts += [proof.t_g, proof.t_h]
    ts.absorb(concat_blobs(*([host_point_bytes(cv, p) for p in group] for group in hosts)))
    cs = ts.sample_field(order)
    L = cv.fr.L
    s_limbs = scalars_to_limbs(proof.response, L, dev, shape)
    c_limbs = scalars_to_limbs(cs, L, dev, shape)
    # variable-base products in one scalar_mul; table bases by their tables
    pairs = [(c_limbs, stmt_a), (c_limbs, stmt_b)]
    pairs += [(s_limbs, base) for base in (base_g, base_h) if not isinstance(base, FixedBaseTable)]
    prods = batch_muls(cv, pairs)
    var = iter(prods[2:])
    lhs_g, lhs_h = (base.mul(s_limbs) if isinstance(base, FixedBaseTable) else next(var) for base in (base_g, base_h))
    rhs_g = cv.add(_unflat(cv, proof.t_g, shape, dev), prods[0])
    rhs_h = cv.add(_unflat(cv, proof.t_h, shape, dev), prods[1])
    if not bool((cv.eq(lhs_g, rhs_g) & cv.eq(lhs_h, rhs_h)).all()):
        raise ProofVerificationError(CHAUM_PEDERSEN)
