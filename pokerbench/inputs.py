"""Inputs from the seed, and the reading of the program's tensors as
integers.

Every run draws its inputs from `--seed`: curve points by a seeded Python
`random.Random` (a random x with a point on it, a random y parity: about a
millisecond a point), scalars and permutations by a seeded numpy
`Generator`. A deck would take about a hundred thousand such points, so a
cell draws a small pool and makes each card the sum of two pool points,
added on the device; the reference adds the same two points again.

Scalars are 16 little-endian 16-bit limbs, canonical, drawn below 2^251
(the Stark group order is 2^251 + 2^196 + ...). The program keeps field
elements as 16-bit limbs in Montgomery form (R = 2^256); `mont_int`,
`affine` and `projective` read them back as integers.
"""

from __future__ import annotations

import random

import numpy as np

from .reference import curve as ec

L = 16
TOP_MASK = (1 << (ec.Q_BITS - 1 - 16 * (L - 1))) - 1  # limb 15 keeps bits 240..250
R_INV = pow(1 << (16 * L), -1, ec.P)


class Draws:
    """The seed's streams for one purpose (`tag`): the same seed and tag
    give the same points, scalars and permutations."""

    def __init__(self, seed: int, tag: str):
        self.py = random.Random(f"{seed}/{tag}")
        self.np = np.random.default_rng([seed & (2**64 - 1), (seed >> 64) & (2**64 - 1), sum(map(ord, tag)), len(tag)])

    def points(self, count: int) -> list:
        out = []
        while len(out) < count:
            pt = ec.point_from_x(self.py.randrange(ec.P), bool(self.py.getrandbits(1)))
            if pt is not None:
                out.append(pt)
        return out

    def scalars(self, shape) -> np.ndarray:
        """int32 [*shape, 16] canonical limbs below 2^251."""
        k = self.np.integers(0, 1 << 16, tuple(shape) + (L,), dtype=np.int32)
        k[..., L - 1] &= TOP_MASK
        return k

    def permutations(self, rows: int, size: int) -> np.ndarray:
        return self.np.permuted(np.tile(np.arange(size, dtype=np.int64), (rows, 1)), axis=1)

    def choose(self, high: int, k: int) -> np.ndarray:
        """min(k, high) distinct indices below `high`."""
        return np.sort(self.np.choice(high, min(k, high), replace=False))

    def pick(self, items: list, k: int) -> list:
        """The last item and min(k, len) - 1 others drawn from the rest."""
        k = min(k, len(items))
        if k == 0:
            return []
        return [items[-1]] + [items[i] for i in self.np.choice(len(items) - 1, k - 1, replace=False)]

    def indices(self, shape, high: int) -> np.ndarray:
        return self.np.integers(0, high, tuple(shape), dtype=np.int64)


def limbs_int(limbs) -> int:
    return sum(int(v) << (16 * i) for i, v in enumerate(limbs))


def mont_int(limbs) -> int:
    return limbs_int(limbs) * R_INV % ec.P


def affine(x, y, inf) -> tuple:
    """One point from Montgomery affine limbs and its identity flag."""
    return ec.IDENTITY if bool(inf) else (mont_int(x), mont_int(y), False)


def projective(x, y, z) -> tuple:
    """One point from Montgomery projective limbs (x = X/Z, y = Y/Z)."""
    zi = mont_int(z)
    if zi == 0:
        return ec.IDENTITY
    inv = pow(zi, -1, ec.P)
    return (mont_int(x) * inv % ec.P, mont_int(y) * inv % ec.P, False)


def affine_list(aff) -> list:
    """An (x, y, inf) triple of tensors [k, 16], [k, 16], [k] -> k points."""
    xs, ys, infs = (t.cpu().numpy() for t in aff)
    return [affine(x, y, i) for x, y, i in zip(xs.reshape(-1, L), ys.reshape(-1, L), infs.reshape(-1))]


def projective_list(pt) -> list:
    xs, ys, zs = (t.cpu().numpy().reshape(-1, L) for t in pt)
    return [projective(x, y, z) for x, y, z in zip(xs, ys, zs)]


def scalar_list(t) -> list:
    return [limbs_int(row) for row in t.cpu().numpy().reshape(-1, L)]
