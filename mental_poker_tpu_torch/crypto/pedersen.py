"""Pedersen vector commitments (counterpart of
`mental_poker_tpu/crypto/pedersen.py`).

commit(m_1..m_n; r) = r H + sum_i m_i G_i over unknown-dlog generators.

The commit key is fixed per game, so a commitment is a fixed-base MSM over the
generators' window tables plus one fixed-base multiply.
"""

from __future__ import annotations

from ..ops.curve import Curve, PointP
from ..ops.msm import FixedBaseMSM, FixedBaseTable
from ..utils.rand import GameRng
from .group import scalars_to_limbs


class CommitKey:
    def __init__(self, cv: Curve, g_hosts: list, h_host, c: int = 4, device="cuda"):
        self.cv = cv
        self.n = len(g_hosts)
        self.g_hosts = list(g_hosts)
        self.h_host = h_host
        self.device = device
        self.g_msm = FixedBaseMSM(cv, self.g_hosts, c, device)
        self.h_table = FixedBaseTable(cv, h_host, c, device)

    def commit(self, vec_limbs, r_limbs) -> PointP:
        """vec_limbs: canonical [..., n, Lk]; r_limbs: [..., Lk] -> PointP [...]."""
        if vec_limbs.shape[-2] != self.n:
            raise ValueError(f"commit: {vec_limbs.shape[-2]}-vectors for a key of {self.n}")
        return self.cv.add(self.g_msm.msm(vec_limbs), self.h_table.mul(r_limbs))

    def commit_ints(self, vec_ints, r_ints) -> PointP:
        """Commit from Python-int vectors: [..., n] nested lists + [...] ints."""
        L = self.cv.fr.L
        return self.commit(scalars_to_limbs(vec_ints, L, self.device), scalars_to_limbs(r_ints, L, self.device))


def setup(cv: Curve, rng: GameRng, n: int, c: int = 4, device="cuda") -> CommitKey:
    """`PedersenCommitment::setup(rng, n)` (`mod.rs:111`): n + 1 random
    unknown-dlog generators."""
    pts = [cv.host.rand_point(rng.rng) for _ in range(n + 1)]
    return CommitKey(cv, pts[:-1], pts[-1], c, device)
