"""Zero argument (Bayer-Groth §5.2; counterpart of
`mental_poker_tpu/arguments/zero.py`).

Claim: given commitments c_A[1..m] (rows a_i) and c_B[1..m] (rows b_i) and a
bilinear map <u, v>_y = sum_j u_j v_j y^j, prove sum_{i=1..m} <a_i, b_i>_y = 0.

Protocol (round-by-round; transcript = the caller's FiatShamirRng):
  P: sample a_0, r_0, b_{m+1}, s_{m+1}; diagonal sums
       d_k = sum_{i in 0..m, j in 1..m+1, j = m+1+i-k} <a_i, b_j>_y,
     k = 0..2m (d_{m+1} = claim = 0); t_k random, t_{m+1} = 0.
     Send c_A0 = com(a_0; r_0), c_B{m+1} = com(b_{m+1}; s_{m+1}),
          c_D[k] = com_scalar(d_k; t_k).
  V: challenge x.
  P: open  a = sum_{i=0..m} x^i a_i,        r = sum x^i r_i,
           b = sum_{j=1..m+1} x^{m+1-j} b_j, s = sum x^{m+1-j} s_j,
           t = sum_{k=0..2m} x^k t_k.
  V: check com(a; r) == sum_{i=0..m} x^i c_A_i          (c_A_0 = c_A0)
           com(b; s) == sum_{j=1..m+1} x^{m+1-j} c_B_j  (c_B_{m+1} = c_B{m+1})
           com_scalar(<a,b>_y; t) == sum_{k=0..2m} x^k c_D[k]
           c_D[m+1] == com_scalar(0; 0)
"""

from __future__ import annotations

import dataclasses

from ..crypto.errors import ZERO_ARG, ProofVerificationError
from ..crypto.transcript import TranscriptBatch
from ..utils.rand import GameRng
from .common import bilinear, com, com_scalar, combo, points_bytes, vec_add, vec_scale


@dataclasses.dataclass
class ZeroProof:
    c_a0: tuple
    c_bm1: tuple
    c_d: list  # 2m+1 host points
    a: list  # n ints
    r: int
    b: list  # n ints
    s: int
    t: int


def prove(ck, ts: TranscriptBatch, rng: GameRng, a_rows, r_list, b_rows, s_list, y) -> ZeroProof:
    cv = ck.cv
    q = cv.host.order
    m = len(a_rows)
    n = ck.n
    a0 = [rng.scalar(q) for _ in range(n)]
    r0 = rng.scalar(q)
    bm1 = [rng.scalar(q) for _ in range(n)]
    sm1 = rng.scalar(q)
    A = [a0] + list(a_rows)  # rows 0..m
    Bv = list(b_rows) + [bm1]  # rows 1..m+1 (index j-1)
    R = [r0] + list(r_list)
    S = list(s_list) + [sm1]

    d = []
    for k in range(2 * m + 1):
        acc = 0
        for i in range(0, m + 1):
            j = m + 1 + i - k
            if 1 <= j <= m + 1:
                acc = (acc + bilinear(A[i], Bv[j - 1], y, q)) % q
        d.append(acc)
    if d[m + 1] % q:
        raise ValueError("zero-argument claim does not hold")
    t = [rng.scalar(q) for _ in range(2 * m + 1)]
    t[m + 1] = 0

    c_a0 = com(ck, a0, r0)
    c_bm1 = com(ck, bm1, sm1)
    c_d = [com_scalar(ck, d[k], t[k]) for k in range(2 * m + 1)]

    ts.absorb([points_bytes(cv, [c_a0, c_bm1] + c_d)])
    x = ts.sample_field(q)[0]

    xi = [pow(x, i, q) for i in range(2 * m + 2)]
    a_open = [0] * n
    r_open = 0
    for i in range(0, m + 1):
        a_open = vec_add(a_open, vec_scale(A[i], xi[i], q), q)
        r_open = (r_open + xi[i] * R[i]) % q
    b_open = [0] * n
    s_open = 0
    for j in range(1, m + 2):
        b_open = vec_add(b_open, vec_scale(Bv[j - 1], xi[m + 1 - j], q), q)
        s_open = (s_open + xi[m + 1 - j] * S[j - 1]) % q
    t_open = 0
    for k in range(2 * m + 1):
        t_open = (t_open + xi[k] * t[k]) % q

    return ZeroProof(c_a0, c_bm1, c_d, a_open, r_open, b_open, s_open, t_open)


def verify(ck, ts: TranscriptBatch, proof: ZeroProof, c_a_hosts, c_b_hosts, y) -> None:
    cv = ck.cv
    q = cv.host.order
    m = len(c_a_hosts)
    ts.absorb([points_bytes(cv, [proof.c_a0, proof.c_bm1] + list(proof.c_d))])
    x = ts.sample_field(q)[0]
    xi = [pow(x, i, q) for i in range(2 * m + 2)]

    lhs_a = com(ck, proof.a, proof.r)
    rhs_a = combo(cv, [proof.c_a0] + list(c_a_hosts), [xi[i] for i in range(m + 1)], ck.device)
    lhs_b = com(ck, proof.b, proof.s)
    rhs_b = combo(cv, list(c_b_hosts) + [proof.c_bm1], [xi[m + 1 - j] for j in range(1, m + 2)], ck.device)
    lhs_d = com_scalar(ck, bilinear(proof.a, proof.b, y, q), proof.t)
    rhs_d = combo(cv, list(proof.c_d), [xi[k] for k in range(2 * m + 1)], ck.device)
    ok = (
        lhs_a == rhs_a
        and lhs_b == rhs_b
        and lhs_d == rhs_d
        and proof.c_d[m + 1] == com_scalar(ck, 0, 0)
    )
    if not ok:
        raise ProofVerificationError(ZERO_ARG)
