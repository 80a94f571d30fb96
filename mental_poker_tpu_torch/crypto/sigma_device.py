"""Device-resident sigma protocols: Schnorr identification and Chaum-Pedersen
discrete-log equality with the Fiat-Shamir transcript on the device
(counterpart of `mental_poker_tpu/crypto/sigma_device.py`).

The transcript byte schedule is `crypto/sigma.py`'s, so a proof made here
verifies there and the other way round. One call proves or verifies a whole
[B] batch of statements with B independent transcripts (`transcript_dev`)
and no copy to the host: the challenge, the response s = k + c*w mod r and
the verification equations stay tensors on the statements' device.

A base is one of two kinds, told apart by its shape:

- a fixed base: a [W, T, L] window table (`FixedBaseTable.table`, the
  ElGamal generator or the aggregate key), multiplied by `ops/msm.py::
  fixed_mul`; its base point, for the transcript, is the table's entry
  [0, 1];
- a variable base: any other `PointP`, batched like the statements (a
  card's c0 in a reveal proof), multiplied by `Curve.scalar_mul`.

So a [G, N] batch of variable bases (coordinates [G, N, L]) would be read
as a table: callers flatten such batches to one batch dimension first (the
port's bench does so for its games).
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..ops.curve import Curve, PointP
from ..ops.msm import fixed_mul
from . import serialize_dev as sd
from . import transcript_dev as dt


class AffPt(NamedTuple):
    """Affine points: Montgomery-limb x, y [..., L] and the identity flag."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


class SchnorrProofDev(NamedTuple):
    t: AffPt  # [B] commitments k * g
    s: torch.Tensor  # [B, L] canonical responses


class CPProofDev(NamedTuple):
    t_g: AffPt  # [B] commitments k * g
    t_h: AffPt  # [B] commitments k * h
    s: torch.Tensor  # [B, L] canonical responses


def _is_table(base) -> bool:
    return isinstance(base, PointP) and base.x.dim() == 3


def _aff(cv: Curve, P: PointP) -> AffPt:
    return AffPt(*cv.to_affine(P))


def _aff_bytes(cv: Curve, a: AffPt) -> torch.Tensor:
    return sd.affine_bytes(cv, a.x, a.y, a.inf)


def _aff_proj(cv: Curve, a: AffPt) -> PointP:
    return cv.from_affine(a.x, a.y, a.inf)


def _mul(cv: Curve, base, k_c) -> PointP:
    """k * base: a fixed-base multiply for a [W, T, L] table, else a
    variable-base `scalar_mul` of the batched point."""
    if _is_table(base):
        return fixed_mul(cv, base, k_c)
    return cv.scalar_mul(k_c, base)


def _base_pt_bytes(cv: Curve, base, batch: tuple) -> torch.Tensor:
    """The base point's bytes, broadcast to the statement batch."""
    if _is_table(base):
        b = sd.point_bytes(cv, PointP(base.x[0, 1], base.y[0, 1], base.z[0, 1]))
        return b.expand(tuple(batch) + b.shape)
    return sd.point_bytes(cv, base)


def _resp(cv: Curve, k_c, c_m, w_c) -> torch.Tensor:
    """s = k + c*w mod r from canonical k and w and the Montgomery-form
    challenge; canonical limbs out."""
    fr = cv.fr
    return fr.from_mont(fr.add(fr.to_mont(k_c), fr.mont_mul(c_m, fr.to_mont(w_c))))


# ---------------------------------------------------------------------------
# Schnorr identification
# ---------------------------------------------------------------------------


def schnorr_prove_dev(cv: Curve, st: dt.DTState, gen, pk: PointP, sk_c, k_c) -> SchnorrProofDev:
    """st: [B] transcripts; pk: PointP [B]; sk_c, k_c: canonical limbs [B, L]."""
    t = _aff(cv, _mul(cv, gen, k_c))
    batch = tuple(k_c.shape[:-1])
    blob = sd.concat_bytes(_base_pt_bytes(cv, gen, batch), sd.point_bytes(cv, pk), _aff_bytes(cv, t))
    st, c_m = dt.sample_field(dt.absorb(st, blob), cv.fr)
    return SchnorrProofDev(t, _resp(cv, k_c, c_m, sk_c))


def schnorr_verify_dev(cv: Curve, st: dt.DTState, gen, pk: PointP, proof: SchnorrProofDev) -> torch.Tensor:
    """bool [B]: s*g == t + c*pk, each lane on its own transcript."""
    batch = tuple(proof.s.shape[:-1])
    blob = sd.concat_bytes(_base_pt_bytes(cv, gen, batch), sd.point_bytes(cv, pk), _aff_bytes(cv, proof.t))
    st, c_m = dt.sample_field(dt.absorb(st, blob), cv.fr)
    lhs = _mul(cv, gen, proof.s)
    rhs = cv.add(_aff_proj(cv, proof.t), cv.scalar_mul(cv.fr.from_mont(c_m), pk))
    return cv.eq(lhs, rhs)


# ---------------------------------------------------------------------------
# Chaum-Pedersen DL-equality
# ---------------------------------------------------------------------------


def _cp_blob(cv: Curve, base_g, base_h, stmt_a: PointP, stmt_b: PointP, t_g: AffPt, t_h: AffPt, batch: tuple):
    return sd.concat_bytes(
        _base_pt_bytes(cv, base_g, batch),
        _base_pt_bytes(cv, base_h, batch),
        sd.point_bytes(cv, stmt_a),
        sd.point_bytes(cv, stmt_b),
        _aff_bytes(cv, t_g),
        _aff_bytes(cv, t_h),
    )


def cp_prove_dev(cv: Curve, st: dt.DTState, base_g, base_h, stmt_a: PointP, stmt_b: PointP, w_c, k_c) -> CPProofDev:
    """Prove a = w*g and b = w*h for [B] statements."""
    t_g = _aff(cv, _mul(cv, base_g, k_c))
    t_h = _aff(cv, _mul(cv, base_h, k_c))
    blob = _cp_blob(cv, base_g, base_h, stmt_a, stmt_b, t_g, t_h, tuple(k_c.shape[:-1]))
    st, c_m = dt.sample_field(dt.absorb(st, blob), cv.fr)
    return CPProofDev(t_g, t_h, _resp(cv, k_c, c_m, w_c))


def cp_verify_dev(cv: Curve, st: dt.DTState, base_g, base_h, stmt_a: PointP, stmt_b: PointP, proof: CPProofDev) -> torch.Tensor:
    """bool [B]: s*g == t_g + c*a and s*h == t_h + c*b."""
    blob = _cp_blob(cv, base_g, base_h, stmt_a, stmt_b, proof.t_g, proof.t_h, tuple(proof.s.shape[:-1]))
    st, c_m = dt.sample_field(dt.absorb(st, blob), cv.fr)
    c_c = cv.fr.from_mont(c_m)
    lhs_g = _mul(cv, base_g, proof.s)
    rhs_g = cv.add(_aff_proj(cv, proof.t_g), cv.scalar_mul(c_c, stmt_a))
    lhs_h = _mul(cv, base_h, proof.s)
    rhs_h = cv.add(_aff_proj(cv, proof.t_h), cv.scalar_mul(c_c, stmt_b))
    return cv.eq(lhs_g, rhs_g) & cv.eq(lhs_h, rhs_h)


def init_batch(seeds: list[bytes], device="cuda") -> dt.DTState:
    """B independent transcripts from per-statement seed bytes (the Blake2s
    digests of the static seeds taken on the host, stacked)."""
    words = np.stack([np.frombuffer(hashlib.blake2s(s).digest(), dtype="<u4").astype(np.int64) for s in seeds])
    return dt.DTState(torch.as_tensor(words, device=device), torch.zeros(len(seeds), dtype=torch.int64, device=device))
