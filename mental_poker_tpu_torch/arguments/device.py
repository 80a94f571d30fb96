"""Types and point/byte helpers of the device shuffle proof (counterpart of
`mental_poker_tpu/arguments/device.py`).

Fr values flow in Montgomery form; proof scalars are emitted canonical.
Proof points are emitted affine (`AffP`). Field names and order match the
JAX package's NamedTuples, so a proof flattens to the same leaf sequence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..crypto import serialize_dev as sd
from ..ops.curve import Curve, PointP


class AffP(NamedTuple):
    """Affine points: x/y Montgomery limbs [..., L], inf bool [...]."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor


class ShuffleKeys(NamedTuple):
    """Per-game fixed-base window tables."""

    gen: PointP  # ElGamal generator [W, T, L]
    pk: PointP  # aggregate public key [W, T, L]
    ckg: PointP  # Pedersen vector generators [n, W, T, L]
    ckh: PointP  # Pedersen blinding generator [W, T, L]
    sgen: PointP  # extra shuffle generator G' [W, T, L]


class ShuffleRand(NamedTuple):
    """Prover randomness, canonical limbs, each with a leading [B] axis."""

    r: torch.Tensor  # [m, L]
    s: torch.Tensor  # [m, L]
    prod_s: torch.Tensor  # [L]
    had_sB: torch.Tensor  # [max(m-2, 0), L]
    zero_a0: torch.Tensor  # [n, L]
    zero_r0: torch.Tensor  # [L]
    zero_bm1: torch.Tensor  # [n, L]
    zero_sm1: torch.Tensor  # [L]
    zero_t: torch.Tensor  # [2m+1, L]
    svp_d: torch.Tensor  # [n, L]
    svp_rd: torch.Tensor  # [L]
    svp_delta: torch.Tensor  # [n, L]
    svp_s1: torch.Tensor  # [L]
    svp_sx: torch.Tensor  # [L]
    me_a0: torch.Tensor  # [n, L]
    me_r0: torch.Tensor  # [L]
    me_b: torch.Tensor  # [2m, L]
    me_s: torch.Tensor  # [2m, L]
    me_tau: torch.Tensor  # [2m, L]


class ZeroProofDev(NamedTuple):
    c_a0: AffP
    c_bm1: AffP
    c_d: AffP  # [2m+1]
    a: torch.Tensor  # [n, L] canonical
    r: torch.Tensor
    b: torch.Tensor  # [n, L]
    s: torch.Tensor
    t: torch.Tensor


class HadamardProofDev(NamedTuple):
    c_B_mid: AffP  # [m-2] (empty when m == 2)
    zero: ZeroProofDev


class SVPProofDev(NamedTuple):
    c_d: AffP
    c_delta: AffP
    c_Delta: AffP
    a_tilde: torch.Tensor  # [n, L]
    r_tilde: torch.Tensor
    b_tilde: torch.Tensor  # [n, L]
    s_tilde: torch.Tensor


class ProductProofDev(NamedTuple):
    c_b: AffP
    hadamard: HadamardProofDev
    svp: SVPProofDev


class MultiExpProofDev(NamedTuple):
    c_a0: AffP
    c_b: AffP  # [2m]
    e0: AffP  # [2m] ciphertext first components
    e1: AffP  # [2m]
    a: torch.Tensor  # [n, L]
    r: torch.Tensor
    b: torch.Tensor
    s: torch.Tensor
    tau: torch.Tensor


class ShuffleProofDev(NamedTuple):
    c_a: AffP  # [m]
    c_b: AffP  # [m]
    product: ProductProofDev
    multi_exp: MultiExpProofDev


class ShuffleChecks(NamedTuple):
    """Per-sub-argument verification flags [B]."""

    hadamard: torch.Tensor
    svp: torch.Tensor
    multi_exp: torch.Tensor


# ---------------------------------------------------------------- trees
# A tree is tuples, NamedTuples and dicts nested to any depth; anything else
# (a tensor, a list) is a leaf. The proof containers, decks, keys and
# randomness bundles above are such trees.


def leaves(tree) -> list:
    """The leaves in order: fields in order, dict values in insertion order."""
    if isinstance(tree, dict):
        return [leaf for t in tree.values() for leaf in leaves(t)]
    if isinstance(tree, tuple):
        return [leaf for t in tree for leaf in leaves(t)]
    return [tree]


def rebuild(template, flat):
    """A tree shaped like `template` with the leaves of `flat`, in order."""
    it = iter(flat)

    def go(t):
        if isinstance(t, dict):
            return {k: go(v) for k, v in t.items()}
        if isinstance(t, tuple):
            parts = [go(c) for c in t]
            return type(t)(*parts) if hasattr(t, "_fields") else tuple(parts)
        return next(it)

    return go(template)


def tree_map(fn, tree):
    """fn over every leaf of a tree (or one tensor)."""
    return rebuild(tree, [fn(t) for t in leaves(tree)])


def to_aff(cv: Curve, P: PointP) -> AffP:
    return AffP(*cv.to_affine(P))


def aff_to_proj(cv: Curve, a: AffP) -> PointP:
    return cv.from_affine(a.x, a.y, a.inf)


def aff_bytes(cv: Curve, a: AffP) -> torch.Tensor:
    """ToBytes blob straight from affine coordinates (no inversion)."""
    return sd.affine_bytes(cv, a.x, a.y, a.inf)


def aff_blob(cv: Curve, a: AffP) -> torch.Tensor:
    """Blobs concatenated over the last point axis."""
    pb = aff_bytes(cv, a)
    return pb if pb.dim() == 1 else pb.flatten(-2)


def table_base(table: PointP) -> PointP:
    """The base point behind a [W, T, L] window table (entry [0, 1])."""
    return PointP(table.x[0, 1], table.y[0, 1], table.z[0, 1])


def cat_affs(*affs: AffP) -> AffP:
    """Concatenate [B, k] AffP groups along axis 1 ([B] groups count as k=1)."""
    parts = [AffP(a.x[:, None], a.y[:, None], a.inf[:, None]) if a.inf.dim() == 1 else a for a in affs]
    return AffP(*(torch.cat([getattr(p, f) for p in parts], dim=1) for f in AffP._fields))


def slice_aff(aff: AffP, i) -> AffP:
    return AffP(aff.x[:, i], aff.y[:, i], aff.inf[:, i])
