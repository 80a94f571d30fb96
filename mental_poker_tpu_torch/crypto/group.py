"""Shared group helpers: base multiplication and transcript bytes
(counterpart of `mental_poker_tpu/crypto/group.py`).

A "base" for scalar multiplication is either a `FixedBaseTable` (the window
table of a per-game fixed point: the ElGamal generator, the aggregate key, the
Pedersen key) or a batched `PointP` (a variable base, e.g. a card's `c0` in a
reveal-token proof).
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..ops.curve import Curve, PointP, map_point, stack_points
from ..ops.msm import FixedBaseTable
from ..utils.rand import ints_to_limbs
from . import serialize

Base = Union[FixedBaseTable, PointP]


def base_device(base: Base) -> torch.device:
    return (base.table if isinstance(base, FixedBaseTable) else base).x.device


def base_mul(cv: Curve, base: Base, k_limbs) -> PointP:
    """k * base for canonical scalar limbs [..., Lk] (a tensor on the base's
    device)."""
    if isinstance(base, FixedBaseTable):
        return base.mul(k_limbs)
    return cv.scalar_mul(k_limbs, base)


def base_point(cv: Curve, base: Base, batch_shape=()) -> PointP:
    """The base as a (broadcast) PointP."""
    if isinstance(base, FixedBaseTable):
        P = PointP(base.table.x[0, 1], base.table.y[0, 1], base.table.z[0, 1])
        return map_point(lambda q: q.expand(tuple(batch_shape) + q.shape[-1:]), P)
    return base


def points_to_bytes(cv: Curve, P: PointP) -> list[bytes]:
    """Batched points -> list of arkworks-`ToBytes` blobs (host), flattened
    C-order over the batch dims."""
    return [serialize.point_to_bytes(h, cv.host) for h in cv.to_host_points(P)]


def host_points(cv: Curve, *points: PointP) -> list[list]:
    """Host (x, y, inf) triples of several batched points (batch shapes
    broadcast), one list per point, flattened C-order, through one
    `to_host_points` (one copy to the host for all of them)."""
    shape = torch.broadcast_shapes(*(p.x.shape[:-1] for p in points))
    stacked = stack_points([map_point(lambda q: q.expand(shape + q.shape[-1:]), p) for p in points])
    flat = cv.to_host_points(stacked)
    n = len(flat) // len(points)
    return [flat[i * n : (i + 1) * n] for i in range(len(points))]


def host_point_bytes(cv: Curve, hp) -> bytes:
    return serialize.point_to_bytes(hp, cv.host)


def concat_blobs(*groups: list[bytes]) -> list[bytes]:
    """Element-wise concatenation of equal-length byte-blob lists (a list of
    one blob broadcasts)."""
    n = max(len(g) for g in groups)
    return [b"".join(g[i if len(g) > 1 else 0] for g in groups) for i in range(n)]


def scalars_to_limbs(vals, L: int, device="cuda", shape=None) -> torch.Tensor:
    """Python ints (nested list or object array) -> canonical int32 limbs on
    `device`, reshaped to `shape + (L,)` when a shape is given."""
    arr = ints_to_limbs(vals, L).astype(np.int32)
    if shape is not None:
        arr = arr.reshape(tuple(shape) + (L,))
    return torch.as_tensor(arr, device=device)
