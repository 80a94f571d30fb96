"""Multi-exponentiation argument (Bayer-Groth §4; counterpart of
`mental_poker_tpu/arguments/multi_exponentiation.py`).

Claim (additive notation): for a ciphertext matrix C (m rows x n), target
ciphertext T and commitments c_A[1..m], prove knowledge of A, r, rho with
      c_A[i] = com(A_i; r_i)   and   T = E(0; rho) + sum_i <A_i, C_i>,
where <A_i, C_i> = sum_j A_ij * C_ij  (a ciphertext MSM).

This is the prover's hot path: the reference's cost model prices the shuffle
at m*N curve exponentiations (`examples/parameter_selection.rs:3`) — they all
live here, as one-statement ciphertext MSMs (ops/msm.py: the gather engine
below 16 points, the lane kernel from 16).

Protocol:
  P: a_0 <- Fr^n, r_0; for k in 0..2m-1: b_k, s_k, tau_k <- Fr with
     b_m = 0, s_m = 0, tau_m = rho.  Exponent rows a_0..a_m (a_i = A_i, i>=1).
     Diagonals D_k = sum_{i=1..m, j=k-m+i in [0,m]} <a_j, C_i>,
     E_k = E(b_k * G'; tau_k) + D_k   (G' = the shuffle generator,
                                       reference `mod.rs:397-402`).
     Send c_A0 = com(a_0; r_0), c_B[k] = com_scalar(b_k; s_k), E[0..2m-1].
  V: challenge x.
  P: open a = a_0 + sum_{j>=1} x^j A_j, r = r_0 + sum x^j r_j,
          b = sum x^k b_k, s = sum x^k s_k, tau = sum x^k tau_k.
  V: check E_m == T;  c_B[m] == com_scalar(0;0);
          com(a; r) == c_A0 + sum_j x^j c_A[j];
          com_scalar(b; s) == sum_k x^k c_B[k];
          sum_k x^k E_k == E(b*G'; tau) + sum_i x^(m-i) <a, C_i>.
"""

from __future__ import annotations

import dataclasses

import torch

from ..crypto import elgamal
from ..crypto.elgamal import Ciphertexts
from ..crypto.errors import MULTI_EXP, ProofVerificationError
from ..crypto.serialize import point_to_bytes
from ..crypto.group import host_points, scalars_to_limbs
from ..crypto.transcript import TranscriptBatch
from ..ops.curve import map_point
from ..utils.rand import GameRng
from .common import com, com_scalar, combo, points_bytes, vec_add, vec_scale


def cipher_to_host(cv, cts: Ciphertexts) -> list:
    """Device ciphertexts (flattened) -> list of (c0_host, c1_host) pairs."""
    return list(zip(*host_points(cv, cts.c0, cts.c1)))


def cipher_from_host(cv, pairs, device="cuda") -> Ciphertexts:
    return Ciphertexts(
        cv.from_host_points([p[0] for p in pairs], device),
        cv.from_host_points([p[1] for p in pairs], device),
    )


def cipher_bytes(cv, pairs) -> bytes:
    return b"".join(
        point_to_bytes(p0, cv.host) + point_to_bytes(p1, cv.host) for p0, p1 in pairs
    )


def _cipher_msm_flat(cv, cts: Ciphertexts, scalar_ints) -> tuple:
    """<scalars, cts> over a flat axis -> host ciphertext pair."""
    k = scalars_to_limbs(scalar_ints, cv.fr.L, cts.c0.x.device)
    return cipher_to_host(cv, elgamal.cipher_msm(cv, cts, k))[0]


def _enc_with_generator(ctx, b: int, tau: int) -> tuple:
    """E(b*G'; tau) = (tau*g_enc, b*G' + tau*pk) -> host pair."""
    cv = ctx["cv"]
    L = cv.fr.L
    dev = ctx["ck"].device
    t = scalars_to_limbs([tau], L, dev)
    bb = scalars_to_limbs([b], L, dev)
    c0 = ctx["enc_gen_table"].mul(t)
    c1 = cv.add(ctx["gen_table"].mul(bb), ctx["pk_table"].mul(t))
    return cipher_to_host(cv, Ciphertexts(c0, c1))[0]


def _cipher_add_host(cv, a, b) -> tuple:
    return (cv.host.add(a[0], b[0]), cv.host.add(a[1], b[1]))


@dataclasses.dataclass
class MultiExpProof:
    c_a0: tuple
    c_b: list  # 2m host points
    e: list  # 2m host ciphertext pairs
    a: list  # n ints
    r: int
    b: int
    s: int
    tau: int


def _flatten_rows(cts: Ciphertexts, rows) -> Ciphertexts:
    """Select and concatenate rows of an [m, n] ciphertext matrix."""
    idx = torch.as_tensor(rows, dtype=torch.long, device=cts.c0.x.device)
    sel = lambda P: map_point(lambda q: q[idx].reshape(-1, q.shape[-1]), P)
    return Ciphertexts(sel(cts.c0), sel(cts.c1))


def prove(
    ctx,
    ts: TranscriptBatch,
    rng: GameRng,
    C: Ciphertexts,  # [m, n] tensors
    a_rows,  # [m][n] ints (A_1..A_m)
    r_list,  # [m] ints
    rho: int,
) -> MultiExpProof:
    cv = ctx["cv"]
    ck = ctx["ck"]
    q = cv.host.order
    m = len(a_rows)
    n = len(a_rows[0])

    a0 = [rng.scalar(q) for _ in range(n)]
    r0 = rng.scalar(q)
    rows = [a0] + [list(x) for x in a_rows]  # exponent rows 0..m
    b_k = [rng.scalar(q) for _ in range(2 * m)]
    s_k = [rng.scalar(q) for _ in range(2 * m)]
    tau_k = [rng.scalar(q) for _ in range(2 * m)]
    b_k[m], s_k[m], tau_k[m] = 0, 0, rho

    # Diagonals D_k = sum over ciphertext rows i (1-indexed) with exponent
    # row j = k - m + i in [0, m].
    e_pairs = []
    for k in range(2 * m):
        sel_rows = []
        sel_scalars = []
        for i in range(1, m + 1):
            j = k - m + i
            if 0 <= j <= m:
                sel_rows.append(i - 1)
                sel_scalars.extend(rows[j])
        blind = _enc_with_generator(ctx, b_k[k], tau_k[k])
        if sel_rows:
            flat = _flatten_rows(C, sel_rows)
            dk = _cipher_msm_flat(cv, flat, sel_scalars)
            e_pairs.append(_cipher_add_host(cv, blind, dk))
        else:
            e_pairs.append(blind)

    c_a0 = com(ck, a0, r0)
    c_bs = [com_scalar(ck, b_k[k], s_k[k]) for k in range(2 * m)]

    ts.absorb([points_bytes(cv, [c_a0] + c_bs) + cipher_bytes(cv, e_pairs)])
    x = ts.sample_field(q)[0]
    xj = [pow(x, j, q) for j in range(2 * m)]

    a_open = list(a0)
    r_open = r0
    for j in range(1, m + 1):
        a_open = vec_add(a_open, vec_scale(rows[j], xj[j], q), q)
        r_open = (r_open + xj[j] * r_list[j - 1]) % q
    b_open = sum(xj[k] * b_k[k] for k in range(2 * m)) % q
    s_open = sum(xj[k] * s_k[k] for k in range(2 * m)) % q
    tau_open = sum(xj[k] * tau_k[k] for k in range(2 * m)) % q

    return MultiExpProof(c_a0, c_bs, e_pairs, a_open, r_open, b_open, s_open, tau_open)


def verify(
    ctx,
    ts: TranscriptBatch,
    proof: MultiExpProof,
    C: Ciphertexts,  # [m, n] tensors
    target,  # host ciphertext pair
    c_a_hosts,  # [m] host points
) -> None:
    cv = ctx["cv"]
    ck = ctx["ck"]
    q = cv.host.order
    m = len(c_a_hosts)

    ts.absorb([points_bytes(cv, [proof.c_a0] + list(proof.c_b)) + cipher_bytes(cv, proof.e)])
    x = ts.sample_field(q)[0]
    xj = [pow(x, j, q) for j in range(2 * m)]

    ok = proof.e[m] == tuple(target)
    ok = ok and proof.c_b[m] == com_scalar(ck, 0, 0)
    lhs_a = com(ck, proof.a, proof.r)
    rhs_a = combo(cv, [proof.c_a0] + list(c_a_hosts), [1] + [pow(x, j, q) for j in range(1, m + 1)], ck.device)
    ok = ok and lhs_a == rhs_a
    lhs_b = com_scalar(ck, proof.b, proof.s)
    rhs_b = combo(cv, list(proof.c_b), xj, ck.device)
    ok = ok and lhs_b == rhs_b

    # sum_k x^k E_k == E(b*G'; tau) + sum_i x^(m-i) <a, C_i>
    e_cts = cipher_from_host(cv, proof.e, ck.device)
    lhs_e0, lhs_e1 = _cipher_msm_flat(cv, e_cts, xj)
    blind = _enc_with_generator(ctx, proof.b, proof.tau)
    all_rows = _flatten_rows(C, list(range(m)))
    scal = []
    for i in range(1, m + 1):
        w = pow(x, m - i, q)
        scal.extend([w * aj % q for aj in proof.a])
    rhs_pair = _cipher_msm_flat(cv, all_rows, scal)
    rhs = _cipher_add_host(cv, blind, rhs_pair)
    ok = ok and (lhs_e0, lhs_e1) == rhs
    if not ok:
        raise ProofVerificationError(MULTI_EXP)
