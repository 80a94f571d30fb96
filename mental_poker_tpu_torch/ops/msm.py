"""Multi-scalar multiplication (counterpart of `mental_poker_tpu/ops/msm.py`).

- Variable-base MSM (`msm`), two engines chosen by the JAX package's rule:
  the per-statement kernel (`ops/cuda/msm.py`, the Hopper twin of the TPU
  lane kernel, or its chunked form when `config.msm_nc` > 1), after the
  wide-split mapping spreads the points of few-statement calls over several
  statements; and, for one statement of
  fewer than 16 points, the gather engine (`msm_gather`): the window sums
  of `gather_window_sums` (which the TP window MSM of
  `parallel/sharding.py` calls over a range of windows), then the
  window-fold kernel (`ops/cuda/curve.py::fold_windows`).
- Fixed-base multiply/MSM (`FixedBaseTable`, `FixedBaseMSM`): full window
  tables T[w][d] = d * 2^(c w) * B built once per base, so a multiply is a
  gather of W entries and a tree sum (W - 1 additions, no doublings). The
  window width c is a constructor argument (8 for the benchmark shape; None
  takes `config.fixed_window_bits`, 4 unless `MPTPU_FIXED_WINDOW` says
  otherwise).

Scalars enter in canonical (non-Montgomery) limb form, int32 [..., Lk].
"""

from __future__ import annotations

import torch

from ..config import get_config, window_bits
from .cuda import curve as cuda_curve
from .cuda import msm as cuda_msm
from .curve import Curve, PointP, map_point, stack_points

# Wide-split mapping: a call with S statements of N points is re-cut into
# S*F statements of ceil(N/F) points (F a power of two) while S*F stays at
# most SPLIT_TARGET statements and every part keeps at least
# max(nc, SPLIT_MIN_POINTS) points (nc: `config.msm_nc`, the chunked kernel's
# points per step; the JAX package's max(nc, 8)). The kernel runs one 64-thread
# block per statement, so this keeps narrow calls (the verifier's few-point
# combos at small batches) from leaving the card idle while one block walks
# all N points.
SPLIT_TARGET = 1024
SPLIT_MIN_POINTS = 8


def scalar_digits(k: torch.Tensor, c: int, nbits: int) -> torch.Tensor:
    """Canonical limbs [..., Lk] -> c-bit digits [W, ...] (LSB window first)."""
    W = -(-nbits // c)
    return cuda_msm.digits(k, c, W).movedim(-1, 0)


def split_factor(S: int, N: int, nc: int = 1) -> int:
    F = 1
    while S * F * 2 <= SPLIT_TARGET and N >= 2 * F * max(nc, SPLIT_MIN_POINTS):
        F *= 2
    return F


def use_lanes(S: int, N: int) -> bool:
    """The JAX package's engine rule for `engine=None` (its TPU path): the
    lane kernel for two or more statements or 16 or more points, else the
    gather engine."""
    return S >= 2 or N >= 16


def msm(cv: Curve, points: PointP, scalars: torch.Tensor, engine: str | None = None) -> PointP:
    """sum_i scalars[..., i] * points[..., i] over the second-to-last axis.

    points: coordinates [..., N, L]; scalars: canonical limbs [..., N, Lk]
    (batch dims broadcast). Returns PointP [..., L].

    `engine`: "lanes" (the per-statement kernel, after the wide-split
    mapping), "gather" (`msm_gather`: per-point tables, one gather, tree
    sums, the window-fold kernel) or None for the JAX package's rule
    (`use_lanes`: lanes when the flat statement count S >= 2 or N >= 16).
    The rule is the same on every device: the JAX package's CPU path always
    gathers, but the port's CPU tests take the route the card takes. The two
    engines give the same sums as points, not the same projective triples.
    """
    L = points.x.shape[-1]
    Lk = scalars.shape[-1]
    N = points.x.shape[-2]
    batch = torch.broadcast_shapes(points.x.shape[:-2], scalars.shape[:-2])
    S = 1
    for d in batch:
        S *= d
    k = scalars.expand(batch + (N, Lk)).reshape(S, N, Lk)
    P = map_point(lambda q: q.expand(batch + (N, L)).reshape(S, N, L), points)
    if engine not in (None, "lanes", "gather"):
        raise ValueError(f"msm: unknown engine {engine!r}")
    if engine == "gather" or (engine is None and not use_lanes(S, N)):
        out = msm_gather(cv, P, k)
        return map_point(lambda q: q.reshape(batch + (L,)), out)
    nc = get_config().msm_nc
    F = split_factor(S, N, nc)
    if F > 1:
        Nf = -(-N // F)
        padn = Nf * F - N
        if padn:  # zero points with zero scalars: digit 0 picks the identity
            k = torch.cat([k, k.new_zeros((S, padn, Lk))], 1)
            P = map_point(lambda q: torch.cat([q, q.new_zeros((S, padn, L))], 1), P)
        k = k.reshape(S * F, Nf, Lk)
        P = map_point(lambda q: q.reshape(S * F, Nf, L), P)
    out = PointP(*cuda_msm.msm_lanes(cv, P, k, nc))
    if F > 1:
        out = cv.sum_points(map_point(lambda q: q.reshape(S, F, L), out), axis=1)
    return map_point(lambda q: q.reshape(batch + (L,)), out)


def msm_gather(cv: Curve, P: PointP, k: torch.Tensor) -> PointP:
    """The gather engine (`mental_poker_tpu/ops/msm.py::_msm_impl`) on flat
    statements: P coordinates [S, N, L], k canonical limbs [S, N, Lk] ->
    PointP [S, L]. The window sums of every window (`gather_window_sums`),
    then the window fold (`ops/cuda/curve.py::fold_windows`, the kernel on
    the card)."""
    c = cuda_curve.FOLD_WINDOW
    W = -(-cv.fr.bits // c)
    return PointP(*cuda_curve.fold_windows(cv, gather_window_sums(cv, P, k, 0, W), c))


def gather_window_sums(cv: Curve, P: PointP, k: torch.Tensor, w0: int, w1: int) -> PointP:
    """Window sums S_w = sum_i digit_w(k_i) * P_i for the windows w0 <= w < w1
    (c = `FOLD_WINDOW` bits, window 0 least significant): P coordinates
    [S, N, L], k canonical limbs [S, N, Lk] -> PointP [w1 - w0, S, L].
    Per-point multiples tables, one gather of each window's entry
    [w1 - w0, S, N, L], a tree sum over N. Windows at or past W (padding
    of a range split into equal parts) have digit 0: the identity."""
    c = cuda_curve.FOLD_WINDOW
    S, N, L = P.x.shape
    table = cv.multiples_table(P, c)  # [S, N, T, L]
    T = table.x.shape[-2]
    digits = scalar_digits(k, c, cv.fr.bits).long()  # [W, S, N]
    W = digits.shape[0]
    if w1 > W:
        digits = torch.cat([digits, digits.new_zeros((w1 - W, S, N))])
    row = torch.arange(S * N, device=k.device).reshape(S, N) * T
    flat_idx = row + digits[w0:w1]  # [w1 - w0, S, N]
    pts = map_point(lambda q: q.reshape(S * N * T, L)[flat_idx], table)  # [w1 - w0, S, N, L]
    return cv.sum_points(pts, axis=2)


def build_window_tables(cv: Curve, bases: PointP, c: int) -> PointP:
    """bases [n, L] -> PointP [n, W, 2^c, L] with entry [i, w, d] =
    d * 2^(c w) * bases[i]: row 0 is the multiples table, each later row the
    previous one doubled c times."""
    W = -(-cv.fr.bits // c)
    row = cv.multiples_table(bases, c)  # [n, 2^c, L]
    rows = [row]
    for _ in range(W - 1):
        for _ in range(c):
            row = cv.dbl(row)
        rows.append(row)
    return stack_points(rows, dim=1)


def _window_bits(table: PointP) -> int:
    return (table.x.shape[-2] - 1).bit_length()


def fixed_mul(cv: Curve, table: PointP, scalars: torch.Tensor) -> PointP:
    """scalars [..., Lk] times the base behind `table` ([W, 2^c, L]): one
    gather of W entries and a tree sum. The window width comes from the
    table's shape."""
    if table.x.dim() == 4:
        table = map_point(lambda q: q[0], table)
    W, T, L = table.x.shape
    c = _window_bits(table)
    digits = scalar_digits(scalars, c, cv.fr.bits).movedim(0, -1).long()  # [..., W]
    flat_idx = torch.arange(W, device=digits.device) * T + digits
    pts = map_point(lambda q: q.reshape(W * T, L)[flat_idx], table)  # [..., W, L]
    return cv.sum_points(pts, axis=pts.x.dim() - 2)


def fixed_msm(cv: Curve, table: PointP, scalars: torch.Tensor) -> PointP:
    """sum_i scalars[..., i] * bases[i] over the bases' tables [n, W, 2^c, L]:
    gather n*W entries, one tree sum."""
    n, W, T, L = table.x.shape
    c = _window_bits(table)
    digits = scalar_digits(scalars, c, cv.fr.bits).movedim(0, -1).long()  # [..., n, W]
    dev = digits.device
    flat_idx = (
        torch.arange(n, device=dev)[:, None] * (W * T) + torch.arange(W, device=dev) * T + digits
    ).flatten(-2)  # [..., n*W]
    pts = map_point(lambda q: q.reshape(n * W * T, L)[flat_idx], table)
    return cv.sum_points(pts, axis=pts.x.dim() - 2)


class FixedBaseTable:
    """Window table of one fixed base; `table`: PointP [W, 2^c, L]."""

    def __init__(self, cv: Curve, host_point, c: int | None = None, device="cuda", table: PointP | None = None):
        self.cv = cv
        if table is None:
            table = map_point(
                lambda q: q[0],
                build_window_tables(cv, cv.from_host_points([host_point], device), window_bits(c)),
            )
        self.c = _window_bits(table)
        self.table = table

    def mul(self, scalars: torch.Tensor) -> PointP:
        """scalars: canonical limbs [..., Lk] -> PointP [..., L]."""
        return fixed_mul(self.cv, self.table, scalars)


class FixedBaseMSM:
    """Window tables of a vector of fixed bases (e.g. a Pedersen commit key);
    `table`: PointP [n, W, 2^c, L]."""

    def __init__(self, cv: Curve, host_points, c: int | None = None, device="cuda", table: PointP | None = None):
        self.cv = cv
        if table is None:
            table = build_window_tables(cv, cv.from_host_points(list(host_points), device), window_bits(c))
        self.c = _window_bits(table)
        self.table = table

    def msm(self, scalars: torch.Tensor) -> PointP:
        """scalars: canonical limbs [..., n, Lk] -> PointP [..., L]."""
        return fixed_msm(self.cv, self.table, scalars)
