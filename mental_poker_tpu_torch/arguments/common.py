"""Shared helpers for the host Bayer-Groth argument stack (counterpart of
`mental_poker_tpu/arguments/common.py`).

Conventions across the stack:
- the deck of N = m*n entries is an m x n matrix, row-major;
- commitments are Pedersen vector commitments to n-vectors (crypto/pedersen);
- scalar and vector algebra runs on the host in Python ints;
- point algebra (commitments, MSM combos, verification equations) runs as
  batched tensor work on the commit key's device. A combo is a one-statement
  MSM of a few points, which the MSM rule sends to the gather engine and so
  to the window-fold kernel.
"""

from __future__ import annotations

from ..crypto import serialize
from ..crypto.group import scalars_to_limbs
from ..crypto.pedersen import CommitKey
from ..ops import msm as msm_mod
from ..ops.curve import Curve


def com(ck: CommitKey, vec, r: int) -> tuple:
    """Commit a Python-int vector (len <= n, zero-padded) -> host point."""
    return com_many(ck, [vec], [r])[0]


def com_many(ck: CommitKey, vecs, rs) -> list:
    """Commit a list of Python-int vectors -> list of host points."""
    v = [list(vec) + [0] * (ck.n - len(vec)) for vec in vecs]
    return ck.cv.to_host_points(ck.commit_ints(v, list(rs)))


def com_scalar(ck: CommitKey, v: int, r: int) -> tuple:
    """Single-value commitment = com((v, 0, ..., 0); r)."""
    return com(ck, [v], r)


def combo(cv: Curve, host_points: list, coeffs: list, device) -> tuple:
    """sum_k coeffs[k] * host_points[k] -> host point (one MSM on `device`)."""
    P = cv.from_host_points(host_points, device)
    k = scalars_to_limbs(coeffs, cv.fr.L, device)
    return cv.to_host_points(msm_mod.msm(cv, P, k))[0]


def points_bytes(cv: Curve, host_points: list) -> bytes:
    return b"".join(serialize.point_to_bytes(p, cv.host) for p in host_points)


def bilinear(a, b, y, q) -> int:
    """<a, b>_y = sum_j a_j b_j y^(j+1) mod q (BG's star-product map)."""
    acc, yp = 0, y
    for aj, bj in zip(a, b):
        acc = (acc + aj * bj % q * yp) % q
        yp = yp * y % q
    return acc


def vec_add(a, b, q):
    return [(x + y) % q for x, y in zip(a, b)]


def vec_scale(a, c, q):
    return [x * c % q for x in a]


def vec_hadamard(a, b, q):
    return [x * y % q for x, y in zip(a, b)]
