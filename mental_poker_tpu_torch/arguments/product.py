"""Product argument (Bayer-Groth §5; counterpart of
`mental_poker_tpu/arguments/product.py`): given c_A[1..m] and a value v, prove
that the product of ALL committed entries equals v:  prod_{i,j} a_ij = v.

Composition (as in the paper):
  1. commit c_b to b = a_1 o ... o a_m (entrywise product of the rows);
  2. Hadamard product argument (§5.1): c_b commits the entrywise row product;
  3. single-value product argument (§5.3): the vector in c_b has product v.

The verifier runs the Hadamard check first, then the SVP check — pinning the
reference's observable failure order (`tests.rs:213-226`).
"""

from __future__ import annotations

import dataclasses

from ..crypto.transcript import TranscriptBatch
from ..utils.rand import GameRng
from . import hadamard, single_value_product as svp
from .common import com, points_bytes, vec_hadamard


@dataclasses.dataclass
class ProductProof:
    c_b: tuple
    hadamard: hadamard.HadamardProof
    svp: svp.SVPProof


def prove(ck, ts: TranscriptBatch, rng: GameRng, a_rows, r_list, v: int) -> ProductProof:
    cv = ck.cv
    q = cv.host.order
    b = list(a_rows[0])
    for row in a_rows[1:]:
        b = vec_hadamard(b, row, q)
    s = rng.scalar(q)
    c_b = com(ck, b, s)
    ts.absorb([points_bytes(cv, [c_b])])
    hp = hadamard.prove(ck, ts, rng, a_rows, r_list, b, s)
    sp = svp.prove(ck, ts, rng, b, s, v)
    return ProductProof(c_b, hp, sp)


def verify(ck, ts: TranscriptBatch, proof: ProductProof, c_a_hosts, v: int) -> None:
    cv = ck.cv
    ts.absorb([points_bytes(cv, [proof.c_b])])
    hadamard.verify(ck, ts, proof.hadamard, c_a_hosts, proof.c_b)
    svp.verify(ck, ts, proof.svp, proof.c_b, v)
