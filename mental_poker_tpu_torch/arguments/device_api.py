"""Host-facing entry points of the device shuffle argument (counterpart of
`mental_poker_tpu/arguments/device_api.py`): prover randomness, per-game
keys, prove, verify, the reference-ordered error, and the conversions
between the device proof and the host `ShuffleProof` dataclass (so that
`proof_io` bytes and the host Bayer-Groth stack interoperate).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..crypto.errors import HADAMARD, MULTI_EXP, SVP_ARG, ProofVerificationError
from ..ops.curve import Curve, map_point
from ..ops.msm import build_window_tables
from ..utils.rand import GameRng, ints_to_limbs, limbs_to_int
from . import device as dev
from . import hadamard as had_mod
from . import multi_exponentiation as me_mod
from . import product as product_mod
from . import shuffle as shuffle_mod
from . import single_value_product as svp_mod
from . import zero as zero_mod
from .staged import StagedShuffle


def sample_shuffle_rand(
    rng: GameRng, m: int, n: int, L: int, order: int, batch: int = 1, device="cuda"
) -> dev.ShuffleRand:
    """The prover's randomness bundle in the JAX package's draw order, each
    leaf with a leading [batch] axis (bulk host sampling, then one copy)."""

    def vec(k):
        if k == 0:
            return np.zeros((batch, 0, L), np.uint32)
        return rng.scalar_limbs(order, (batch, k), L)

    def one():
        return rng.scalar_limbs(order, (batch,), L)

    host = dev.ShuffleRand(
        r=vec(m), s=vec(m), prod_s=one(), had_sB=vec(max(m - 2, 0)),
        zero_a0=vec(n), zero_r0=one(), zero_bm1=vec(n), zero_sm1=one(), zero_t=vec(2 * m + 1),
        svp_d=vec(n), svp_rd=one(), svp_delta=vec(n), svp_s1=one(), svp_sx=one(),
        me_a0=vec(n), me_r0=one(), me_b=vec(2 * m), me_s=vec(2 * m), me_tau=vec(2 * m),
    )
    return dev.ShuffleRand(*(torch.as_tensor(a.astype(np.int32), device=device) for a in host))


def make_keys(pp, shared_key) -> dev.ShuffleKeys:
    """Per-(game, aggregate key) window tables of the protocol objects
    (`protocol/dl_cards.py`): their own tables, none built anew but the
    shuffle generator's, once per game."""
    return dev.ShuffleKeys(
        gen=pp.enc.gen_table.table,
        pk=shared_key.table.table,
        ckg=pp.commit_key.g_msm.table,
        ckh=pp.commit_key.h_table.table,
        sgen=pp.shuffle_table.table,
    )


def keys_from_points(cv: Curve, generator, pk, commit_g, commit_h, shuffle_generator, c: int = 4, device="cuda") -> dev.ShuffleKeys:
    """Per-(game, aggregate key) window tables from host points: the ElGamal
    generator, the aggregate key, the n Pedersen generators, the Pedersen
    blinding generator and the shuffle generator G'. All n + 4 tables are
    built in one batched pass."""
    bases = [generator, pk, *commit_g, commit_h, shuffle_generator]
    t = build_window_tables(cv, cv.from_host_points(bases, device), c)  # [n+4, W, T, L]
    n = len(commit_g)
    pick = lambda i: map_point(lambda q: q[i], t)
    return dev.ShuffleKeys(
        gen=pick(0),
        pk=pick(1),
        ckg=map_point(lambda q: q[2 : 2 + n], t),
        ckh=pick(2 + n),
        sgen=pick(3 + n),
    )


@functools.cache
def get_staged(cv: Curve, m: int, n: int) -> StagedShuffle:
    return StagedShuffle(cv, m, n)


def prove_shuffle(cv: Curve, m: int, n: int, keys, deck_in, deck_out, pi, rho_c, rand) -> dev.ShuffleProofDev:
    """Batch-first prove. deck_*: [B, N] ciphertexts, pi int [B, N], rho_c
    canonical [B, N, Lk], rand leaves [B, ...]."""
    return get_staged(cv, m, n).prove(keys, deck_in, deck_out, pi, rho_c, rand)


def verify_shuffle(cv: Curve, m: int, n: int, keys, deck_in, deck_out, proof) -> dev.ShuffleChecks:
    """Batch-first verify -> ShuffleChecks flags [B]."""
    return get_staged(cv, m, n).verify(keys, deck_in, deck_out, proof)


def raise_by_flags(checks: dev.ShuffleChecks) -> None:
    """Raise for the first failing sub-check in the reference's order:
    Hadamard (5.1), then SVP (5.3), then multi-exponentiation (4.1)."""
    if not bool(checks.hadamard.all()):
        raise ProofVerificationError(HADAMARD)
    if not bool(checks.svp.all()):
        raise ProofVerificationError(SVP_ARG)
    if not bool(checks.multi_exp.all()):
        raise ProofVerificationError(MULTI_EXP)


# ---------------------------------------------------------------------------
# device proof <-> host dataclass conversion
# ---------------------------------------------------------------------------


def squeeze_proof(p: dev.ShuffleProofDev) -> dev.ShuffleProofDev:
    """Drop the leading batch axis of a B == 1 proof."""
    return dev.tree_map(lambda t: t[0], p)


def expand_proof(p: dev.ShuffleProofDev) -> dev.ShuffleProofDev:
    """Add a leading batch axis (B == 1)."""
    return dev.tree_map(lambda t: t[None], p)


def _aff_to_hosts(cv: Curve, a: dev.AffP) -> list:
    f = cv.fq
    xs, ys, infs = (t.cpu().numpy() for t in a)
    if xs.ndim == 1:
        xs, ys, infs = xs[None], ys[None], infs[None]
    return [cv.host.identity if i else (f.to_int(x), f.to_int(y), False) for x, y, i in zip(xs, ys, infs)]


def _hosts_to_aff(cv: Curve, pts, device, squeeze: bool = False) -> dev.AffP:
    f = cv.fq
    xs = np.stack([f.from_int(0 if p[2] else p[0]) for p in pts]).astype(np.int32)
    ys = np.stack([f.from_int(1 if p[2] else p[1]) for p in pts]).astype(np.int32)
    infs = np.array([bool(p[2]) for p in pts])
    if squeeze:
        xs, ys, infs = xs[0], ys[0], infs[0]
    return dev.AffP(*(torch.as_tensor(a, device=device) for a in (xs, ys, infs)))


def _limbs_to_ints(t: torch.Tensor):
    a = t.cpu().numpy()
    if a.ndim == 1:
        return limbs_to_int(a)
    return [limbs_to_int(row) for row in a]


def _ints_to_limb_arr(vals, L: int, device, scalar: bool = False) -> torch.Tensor:
    arr = ints_to_limbs(list(vals) if isinstance(vals, list) else [vals], L).astype(np.int32)
    return torch.as_tensor(arr[0] if scalar else arr, device=device)


def dev_proof_to_host(cv: Curve, p: dev.ShuffleProofDev) -> shuffle_mod.ShuffleProof:
    """Device proof (unbatched, or batched with B == 1) -> host dataclass
    proof. One inversion per point leaf (`to_int` of affine limbs on the
    host), which is cheap at B = 1."""
    if p.c_a.x.dim() == 3:
        if p.c_a.x.shape[0] != 1:
            raise ValueError("host proofs are single-statement: convert a B == 1 proof")
        p = squeeze_proof(p)
    zero = p.product.hadamard.zero
    svp = p.product.svp
    me = p.multi_exp
    hosts = lambda a: _aff_to_hosts(cv, a)
    one = lambda a: _aff_to_hosts(cv, a)[0]
    mid = p.product.hadamard.c_B_mid
    return shuffle_mod.ShuffleProof(
        c_a=hosts(p.c_a),
        c_b=hosts(p.c_b),
        product=product_mod.ProductProof(
            c_b=one(p.product.c_b),
            hadamard=had_mod.HadamardProof(
                c_B_mid=hosts(mid) if mid.x.shape[0] else [],
                zero=zero_mod.ZeroProof(
                    c_a0=one(zero.c_a0),
                    c_bm1=one(zero.c_bm1),
                    c_d=hosts(zero.c_d),
                    a=_limbs_to_ints(zero.a),
                    r=_limbs_to_ints(zero.r),
                    b=_limbs_to_ints(zero.b),
                    s=_limbs_to_ints(zero.s),
                    t=_limbs_to_ints(zero.t),
                ),
            ),
            svp=svp_mod.SVPProof(
                c_d=one(svp.c_d),
                c_delta=one(svp.c_delta),
                c_Delta=one(svp.c_Delta),
                a_tilde=_limbs_to_ints(svp.a_tilde),
                r_tilde=_limbs_to_ints(svp.r_tilde),
                b_tilde=_limbs_to_ints(svp.b_tilde),
                s_tilde=_limbs_to_ints(svp.s_tilde),
            ),
        ),
        multi_exp=me_mod.MultiExpProof(
            c_a0=one(me.c_a0),
            c_b=hosts(me.c_b),
            e=list(zip(hosts(me.e0), hosts(me.e1))),
            a=_limbs_to_ints(me.a),
            r=_limbs_to_ints(me.r),
            b=_limbs_to_ints(me.b),
            s=_limbs_to_ints(me.s),
            tau=_limbs_to_ints(me.tau),
        ),
    )


def host_proof_to_dev(cv: Curve, p: shuffle_mod.ShuffleProof, device="cuda") -> dev.ShuffleProofDev:
    """Host dataclass proof -> batched (B == 1) device proof on `device`."""
    L = cv.fr.L
    zero = p.product.hadamard.zero
    svp = p.product.svp
    me = p.multi_exp
    aff = lambda pts: _hosts_to_aff(cv, pts, device)
    one = lambda pt: _hosts_to_aff(cv, [pt], device, squeeze=True)
    vec = lambda vals: _ints_to_limb_arr(vals, L, device)
    sc = lambda v: _ints_to_limb_arr(v, L, device, scalar=True)
    fqL = cv.fq.L
    empty = dev.AffP(
        torch.zeros((0, fqL), dtype=torch.int32, device=device),
        torch.zeros((0, fqL), dtype=torch.int32, device=device),
        torch.zeros((0,), dtype=torch.bool, device=device),
    )
    mid = p.product.hadamard.c_B_mid
    proof = dev.ShuffleProofDev(
        c_a=aff(p.c_a),
        c_b=aff(p.c_b),
        product=dev.ProductProofDev(
            c_b=one(p.product.c_b),
            hadamard=dev.HadamardProofDev(
                c_B_mid=aff(mid) if mid else empty,
                zero=dev.ZeroProofDev(
                    c_a0=one(zero.c_a0), c_bm1=one(zero.c_bm1), c_d=aff(zero.c_d),
                    a=vec(zero.a), r=sc(zero.r), b=vec(zero.b), s=sc(zero.s), t=sc(zero.t),
                ),
            ),
            svp=dev.SVPProofDev(
                c_d=one(svp.c_d), c_delta=one(svp.c_delta), c_Delta=one(svp.c_Delta),
                a_tilde=vec(svp.a_tilde), r_tilde=sc(svp.r_tilde),
                b_tilde=vec(svp.b_tilde), s_tilde=sc(svp.s_tilde),
            ),
        ),
        multi_exp=dev.MultiExpProofDev(
            c_a0=one(me.c_a0),
            c_b=aff(me.c_b),
            e0=aff([pair[0] for pair in me.e]),
            e1=aff([pair[1] for pair in me.e]),
            a=vec(me.a), r=sc(me.r), b=sc(me.b), s=sc(me.s), tau=sc(me.tau),
        ),
    )
    return expand_proof(proof)
