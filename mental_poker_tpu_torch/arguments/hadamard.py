"""Hadamard product argument (Bayer-Groth §5.1; counterpart of
`mental_poker_tpu/arguments/hadamard.py`).

Claim: given c_A[1..m] (rows a_i) and c_b, the vector committed in c_b equals
the entrywise product a_1 o a_2 o ... o a_m.

Reduction: let B_1 = a_1, B_i = B_{i-1} o a_i (so B_m = b). Commit the middle
partial products (c_B1 = c_A1 and c_Bm = c_b are reused). After challenges
x, y the claim
      for i = 1..m-1:  B_i o a_{i+1} = B_{i+1}
is batched into one zero-argument instance over the bilinear map <.,.>_y:

  rows A' = (d_1, ..., d_{m-1}, d)  with d_i = x^i B_i,  d = sum x^i B_{i+1}
  rows B' = (a_2, ..., a_m, -1vec)
  claim   sum_i <d_i, a_{i+1}>_y + <d, -1vec>_y = 0.

Commitments for the reduced rows are challenge combinations of the originals,
so the verifier recomputes them homomorphically.

The zero-argument failure is surfaced as "Hadamard Product (5.1)" — matching
the reference's observable behavior where a tampered output deck fails the
shuffle verification with exactly this error (`tests.rs:213-226`).
"""

from __future__ import annotations

import dataclasses

from ..crypto.errors import HADAMARD, ProofVerificationError
from ..crypto.transcript import TranscriptBatch
from ..utils.rand import GameRng
from . import zero as zero_arg
from .common import com, com_many, combo, points_bytes, vec_hadamard, vec_scale, vec_add


@dataclasses.dataclass
class HadamardProof:
    c_B_mid: list  # commitments to B_2..B_{m-1} (empty when m == 2)
    zero: zero_arg.ZeroProof


def prove(ck, ts: TranscriptBatch, rng: GameRng, a_rows, r_list, b, s: int) -> HadamardProof:
    """a_rows: m rows (ints), r_list their commitment randomness; b = prod
    rows (n ints), s its randomness."""
    cv = ck.cv
    q = cv.host.order
    m = len(a_rows)
    n = ck.n
    if m < 2:
        raise ValueError("Hadamard argument needs m >= 2")

    B = [list(a_rows[0])]
    for i in range(1, m):
        B.append(vec_hadamard(B[-1], a_rows[i], q))
    if B[-1] != list(b):
        raise ValueError("Hadamard claim does not hold")

    s_B = [r_list[0]] + [rng.scalar(q) for _ in range(m - 2)] + [s]
    c_B_mid = com_many(ck, B[1:-1], s_B[1:-1]) if m > 2 else []

    ts.absorb([points_bytes(cv, c_B_mid) if c_B_mid else b"hadamard:no-mid"])
    x = ts.sample_field(q)[0]
    y = ts.sample_field(q)[0]

    xi = [pow(x, i, q) for i in range(m + 1)]
    # zero-argument rows: A' = (x^i B_i)_{i=1..m-1} + (sum x^i B_{i+1});
    #                     B' = (a_{i+1})_{i=1..m-1} + (-1vec)
    d_rows = [vec_scale(B[i - 1], xi[i], q) for i in range(1, m)]
    d_sum = [0] * n
    t_sum = 0
    for i in range(1, m):
        d_sum = vec_add(d_sum, vec_scale(B[i], xi[i], q), q)
        t_sum = (t_sum + xi[i] * s_B[i]) % q
    a_rows_z = d_rows + [d_sum]
    r_rows_z = [xi[i] * s_B[i - 1] % q for i in range(1, m)] + [t_sum]
    b_rows_z = [list(a_rows[i]) for i in range(1, m)] + [[(-1) % q] * n]
    s_rows_z = list(r_list[1:]) + [0]

    zp = zero_arg.prove(ck, ts, rng, a_rows_z, r_rows_z, b_rows_z, s_rows_z, y)
    return HadamardProof(c_B_mid, zp)


def verify(ck, ts: TranscriptBatch, proof: HadamardProof, c_a_hosts, c_b) -> None:
    cv = ck.cv
    q = cv.host.order
    m = len(c_a_hosts)
    n = ck.n
    ts.absorb([points_bytes(cv, proof.c_B_mid) if proof.c_B_mid else b"hadamard:no-mid"])
    x = ts.sample_field(q)[0]
    y = ts.sample_field(q)[0]

    xi = [pow(x, i, q) for i in range(m + 1)]
    c_B = [c_a_hosts[0]] + list(proof.c_B_mid) + [c_b]
    # commitments to the reduced zero-argument rows
    c_D = [combo(cv, [c_B[i - 1]], [xi[i]], ck.device) for i in range(1, m)]
    c_Dsum = combo(cv, c_B[1:], [xi[i] for i in range(1, m)], ck.device)
    c_minus1 = com(ck, [(-1) % q] * n, 0)
    c_a_z = c_D + [c_Dsum]
    c_b_z = list(c_a_hosts[1:]) + [c_minus1]
    try:
        zero_arg.verify(ck, ts, proof.zero, c_a_z, c_b_z, y)
    except ProofVerificationError as e:
        raise ProofVerificationError(HADAMARD) from e
