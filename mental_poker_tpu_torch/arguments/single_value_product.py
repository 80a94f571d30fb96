"""Single-value product argument (Bayer-Groth §5.3; counterpart of
`mental_poker_tpu/arguments/single_value_product.py`).

Claim: the vector committed in c_a has product v: prod_j a_j = v  (j = 1..n).

Protocol:
  P: partial products b_1 = a_1, b_j = b_{j-1} a_j (b_n = v);
     sample d_1..d_n, r_d; delta_1 = d_1, delta_n = 0, delta_2..n-1 random;
     s_1, s_x.  Send:
       c_d     = com(d; r_d)
       c_delta = com(-delta_1 d_2, ..., -delta_{n-1} d_n; s_1)
       c_Delta = com(delta_2 - a_2 delta_1 - b_1 d_2, ...,
                     delta_n - a_n delta_{n-1} - b_{n-1} d_n; s_x)
  V: challenge x.
  P: open  ã_j = x a_j + d_j,   r̃ = x r + r_d,
           b̃_j = x b_j + delta_j, s̃ = x s_x + s_1.
  V: check com(ã; r̃) == x c_a + c_d
           com(x b̃_2 - b̃_1 ã_2, ..., x b̃_n - b̃_{n-1} ã_n; s̃)
                       == x c_Delta + c_delta
           b̃_1 == ã_1  and  b̃_n == x v.
"""

from __future__ import annotations

import dataclasses

from ..crypto.errors import SVP_ARG, ProofVerificationError
from ..crypto.transcript import TranscriptBatch
from ..utils.rand import GameRng
from .common import com, combo, points_bytes


@dataclasses.dataclass
class SVPProof:
    c_d: tuple
    c_delta: tuple
    c_Delta: tuple
    a_tilde: list
    r_tilde: int
    b_tilde: list
    s_tilde: int


def prove(ck, ts: TranscriptBatch, rng: GameRng, a, r: int, v: int) -> SVPProof:
    cv = ck.cv
    q = cv.host.order
    n = len(a)
    b = [a[0]]
    for j in range(1, n):
        b.append(b[-1] * a[j] % q)
    if b[-1] != v % q:
        raise ValueError("product claim does not hold")

    d = [rng.scalar(q) for _ in range(n)]
    r_d = rng.scalar(q)
    delta = [rng.scalar(q) for _ in range(n)]
    delta[0] = d[0]
    delta[-1] = 0
    s1 = rng.scalar(q)
    sx = rng.scalar(q)

    c_d = com(ck, d, r_d)
    c_delta = com(ck, [(-delta[j - 1] * d[j]) % q for j in range(1, n)], s1)
    c_Delta = com(
        ck,
        [
            (delta[j] - a[j] * delta[j - 1] - b[j - 1] * d[j]) % q
            for j in range(1, n)
        ],
        sx,
    )

    ts.absorb([points_bytes(cv, [c_d, c_delta, c_Delta])])
    x = ts.sample_field(q)[0]

    a_t = [(x * a[j] + d[j]) % q for j in range(n)]
    r_t = (x * r + r_d) % q
    b_t = [(x * b[j] + delta[j]) % q for j in range(n)]
    s_t = (x * sx + s1) % q
    return SVPProof(c_d, c_delta, c_Delta, a_t, r_t, b_t, s_t)


def verify(ck, ts: TranscriptBatch, proof: SVPProof, c_a, v: int) -> None:
    cv = ck.cv
    q = cv.host.order
    n = len(proof.a_tilde)
    ts.absorb([points_bytes(cv, [proof.c_d, proof.c_delta, proof.c_Delta])])
    x = ts.sample_field(q)[0]

    lhs1 = com(ck, proof.a_tilde, proof.r_tilde)
    rhs1 = combo(cv, [c_a, proof.c_d], [x, 1], ck.device)
    e = [
        (x * proof.b_tilde[j] - proof.b_tilde[j - 1] * proof.a_tilde[j]) % q
        for j in range(1, n)
    ]
    lhs2 = com(ck, e, proof.s_tilde)
    rhs2 = combo(cv, [proof.c_Delta, proof.c_delta], [x, 1], ck.device)
    ok = (
        lhs1 == rhs1
        and lhs2 == rhs2
        and proof.b_tilde[0] == proof.a_tilde[0]
        and proof.b_tilde[-1] == x * v % q
    )
    if not ok:
        raise ProofVerificationError(SVP_ARG)
