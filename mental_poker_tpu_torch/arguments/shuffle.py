"""Bayer-Groth argument of correct shuffle (counterpart of
`mental_poker_tpu/arguments/shuffle.py`; reference E8,
`proof_essentials::zkp::arguments::shuffle` — use-sites
`src/discrete_log_cards/mod.rs:397-415,427-442`).

Statement: input deck C, output deck C' (N = m*n ElGamal ciphertexts each),
shared key pk. Claim: there are a permutation pi and factors rho_i with
      C'_i = C_{pi(i)} + E(0; rho_i).

Protocol (transcript seeded by the protocol layer with "Shuffle Proof",
`mod.rs:80-84`; this framework's documented absorb schedule):
  absorb(statement: pk || root(C) || root(C') || m || n)
    where root(.) is the binary Blake2s Merkle root over per-card
    (c0 || c1) ToBytes leaves (`_deck_root`; odd nodes promote) — the
    tree form keeps the device-resident absorb lane-parallel
  P->V: c_A = com rows of (a_i) = (pi(i)+1)            -> challenge x
  P->V: c_B = com rows of (b_i) = x^{a_i}              -> challenges y, z
  then two sub-arguments over the same transcript, product first:
  - product argument on c_D[k] = y*c_A[k] + c_B[k] + com(-z..;0) with value
        v = prod_{i=1..N} (y*i + x^i - z)
  - multi-exponentiation argument: target T = sum_{i=1..N} x^i * C_i equals
        E(0; rho*) + sum_i b_i * C'_i with rho* = -sum_i rho_i b_i,
    exponent rows B committed by c_B, ciphertext matrix = C' as m x n.

Verification order (product -> within it Hadamard -> SVP -> multi-exp)
reproduces the reference's observable failure `"Hadamard Product (5.1)"` for
a substituted output deck (`tests.rs:213-226`).
"""

from __future__ import annotations

import dataclasses
import hashlib

from ..crypto import serialize
from ..crypto.elgamal import Ciphertexts
from ..crypto.transcript import TranscriptBatch
from ..ops.curve import map_point
from ..utils.rand import GameRng
from . import multi_exponentiation as me
from . import product as product_arg
from .common import com_many, combo, com, points_bytes


@dataclasses.dataclass
class ShuffleProof:
    c_a: list  # m host points
    c_b: list  # m host points
    product: product_arg.ProductProof
    multi_exp: me.MultiExpProof


def _as_matrix(cts: Ciphertexts, m: int, n: int) -> Ciphertexts:
    rs = lambda P: map_point(lambda q: q.reshape(m, n, q.shape[-1]), P)
    return Ciphertexts(rs(cts.c0), rs(cts.c1))


def _deck_root(cv, deck) -> bytes:
    """Binary Blake2s Merkle root over per-card (c0 || c1) ToBytes leaves;
    odd nodes promote unchanged. Device twin: arguments/staged.py
    `_deck_root_dev` (absorb schedules are this framework's own spec; the
    tree form keeps the device absorb lane-parallel instead of ~214
    sequential Blake2s compressions over the flat deck stream)."""
    cards = me.cipher_to_host(cv, deck)
    level = [hashlib.blake2s(me.cipher_bytes(cv, [c])).digest() for c in cards]
    while len(level) > 1:
        nxt = [
            hashlib.blake2s(level[i] + level[i + 1]).digest()
            for i in range(0, len(level) - 1, 2)
        ]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def _statement_bytes(pp, shared_key, deck_in, deck_out) -> bytes:
    cv = pp.cv
    blob = serialize.point_to_bytes(shared_key.host, cv.host)
    blob += _deck_root(cv, deck_in)
    blob += _deck_root(cv, deck_out)
    blob += pp.m.to_bytes(8, "little") + pp.n.to_bytes(8, "little")
    return blob


def _ctx(pp, shared_key):
    return {
        "cv": pp.cv,
        "ck": pp.commit_key,
        "enc_gen_table": pp.enc.gen_table,
        "pk_table": shared_key.table,
        "gen_table": pp.shuffle_table,
    }


def prove(
    rng: GameRng,
    pp,
    shared_key,
    deck_in: Ciphertexts,
    deck_out: Ciphertexts,
    permutation,
    masking_factors,
    ts: TranscriptBatch,
) -> ShuffleProof:
    cv = pp.cv
    q = cv.host.order
    m, n = pp.m, pp.n
    N = m * n
    pi = [int(v) for v in permutation]
    rho = [int(v) % q for v in masking_factors]
    if len(pi) != N or len(rho) != N:
        raise ValueError(f"a shuffle of {N} cards needs {N} indices and {N} masking factors")

    ts.absorb([_statement_bytes(pp, shared_key, deck_in, deck_out)])

    a_vals = [(pi[i] + 1) % q for i in range(N)]
    a_rows = [a_vals[k * n : (k + 1) * n] for k in range(m)]
    r_list = [rng.scalar(q) for _ in range(m)]
    c_a = com_many(pp.commit_key, a_rows, r_list)
    ts.absorb([points_bytes(cv, c_a)])
    x = ts.sample_field(q)[0]

    b_vals = [pow(x, pi[i] + 1, q) for i in range(N)]
    b_rows = [b_vals[k * n : (k + 1) * n] for k in range(m)]
    s_list = [rng.scalar(q) for _ in range(m)]
    c_b = com_many(pp.commit_key, b_rows, s_list)
    ts.absorb([points_bytes(cv, c_b)])
    y = ts.sample_field(q)[0]
    z = ts.sample_field(q)[0]

    # ---- product argument: committed entries y*a + b - z have product v
    dz_rows = [
        [(y * a_rows[k][j] + b_rows[k][j] - z) % q for j in range(n)] for k in range(m)
    ]
    t_list = [(y * r_list[k] + s_list[k]) % q for k in range(m)]
    v = 1
    for i in range(1, N + 1):
        v = v * ((y * i + pow(x, i, q) - z) % q) % q
    prod_proof = product_arg.prove(pp.commit_key, ts, rng, dz_rows, t_list, v)

    # ---- multi-exponentiation argument
    rho_star = (-sum(r * b % q for r, b in zip(rho, b_vals))) % q
    ctx = _ctx(pp, shared_key)
    me_proof = me.prove(ctx, ts, rng, _as_matrix(deck_out, m, n), b_rows, s_list, rho_star)

    return ShuffleProof(c_a, c_b, prod_proof, me_proof)


def verify(
    pp,
    shared_key,
    deck_in: Ciphertexts,
    deck_out: Ciphertexts,
    proof: ShuffleProof,
    ts: TranscriptBatch,
) -> None:
    cv = pp.cv
    q = cv.host.order
    m, n = pp.m, pp.n
    N = m * n

    ts.absorb([_statement_bytes(pp, shared_key, deck_in, deck_out)])
    ts.absorb([points_bytes(cv, proof.c_a)])
    x = ts.sample_field(q)[0]
    ts.absorb([points_bytes(cv, proof.c_b)])
    y = ts.sample_field(q)[0]
    z = ts.sample_field(q)[0]

    # ---- product argument
    c_mz = com(pp.commit_key, [(-z) % q] * n, 0)
    c_d = [
        cv.host.add(combo(cv, [proof.c_a[k], proof.c_b[k]], [y, 1], pp.commit_key.device), c_mz)
        for k in range(m)
    ]
    v = 1
    for i in range(1, N + 1):
        v = v * ((y * i + pow(x, i, q) - z) % q) % q
    product_arg.verify(pp.commit_key, ts, proof.product, c_d, v)

    # ---- multi-exponentiation argument
    xpow = [pow(x, i, q) for i in range(1, N + 1)]
    T = me._cipher_msm_flat(cv, deck_in, xpow)
    ctx = _ctx(pp, shared_key)
    me.verify(ctx, ts, proof.multi_exp, _as_matrix(deck_out, m, n), T, proof.c_b)
