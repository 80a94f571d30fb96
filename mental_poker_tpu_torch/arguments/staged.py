"""Bayer-Groth shuffle prove and verify on the device (counterpart of
`mental_poker_tpu/arguments/staged.py`).

`StagedShuffle.prove` / `.verify` run the JAX package's stage flow as plain
Python methods that execute eagerly: commit, absorb and sample, the Fr
algebra of each sub-argument, the openings, and the verifier's homomorphic
combinations as per-statement MSMs. Every array carries a leading [B] proof
axis, so one call proves or verifies B independent shuffles; all state
between stages stays on the device, and the host reads nothing back until
the flags (the transcript's rejection sampling excepted).

Transcript byte schedules are the JAX package's, so the same statement,
witness and randomness give the same proof, leaf for leaf.

With `stage_timing` on (`MPTPU_STAGE_TIMING=1`), each stage method is timed
into `STAGE_TIMES` under the JAX package's program keys, and
`stage_report()` reads them as the JAX package's does.

With `fuse_b_max` set (`MPTPU_FUSE_B`), a prove or verify of B proofs with
0 < B <= `fuse_b_max` runs its flow fused, as the JAX package's `_fused`
does: on the card as one CUDA graph (`fused.py`). While fusing, the stages
neither time nor fence, and each challenge is one round of candidate draws
with no host sync (`_sample`). Every tensor the flow builds from host
values is made once per device (`_const`, and the caches of the transcript
and byte-layout modules), so that the flow copies nothing from the host.
"""

from __future__ import annotations

import functools
import time

import numpy as np
import torch

from .. import config
from ..crypto import hash_dev
from ..crypto import serialize_dev as sd
from ..crypto import transcript_dev as dt
from ..crypto.elgamal import Ciphertexts
from ..crypto.transcript import SHUFFLE_RNG_SEED
from ..ops import msm as msm_mod
from ..ops.curve import Curve, PointP, cat_points, map_point, stack_points
from ..ops.msm import fixed_msm, fixed_mul
from .device import (
    AffP,
    HadamardProofDev,
    MultiExpProofDev,
    ProductProofDev,
    ShuffleChecks,
    ShuffleKeys,
    ShuffleProofDev,
    ShuffleRand,
    SVPProofDev,
    ZeroProofDev,
    aff_blob,
    aff_bytes,
    aff_to_proj,
    cat_affs,
    slice_aff,
    table_base,
    to_aff,
)

_NO_MID = b"hadamard:no-mid"

# When True, verify() returns (ShuffleChecks, dict of the raw sub-check
# flags) so a failing flag can be localised.
DEBUG_FLAGS = False

# True while a fused flow runs (`StagedShuffle._fused`): the stage wrappers
# neither time nor fence, and `_sample` draws one round of candidates,
# keeping each draw's undone lanes in `_UNDONE` for `fused.py` to count.
_FUSING = [False]
_UNDONE: list = []

# Per-stage wall-clock accounting, on with `stage_timing`
# (MPTPU_STAGE_TIMING=1): key -> [total_s, calls, first_call_s]. The first
# call includes the kernel libraries' load; the steady cost is
# (total - first) / (calls - 1).
STAGE_TIMES: dict = {}


def stage_report() -> list:
    """[(key, steady_ms_per_call, calls, first_s)] sorted by total steady time."""
    rows = []
    for k, (tot, n, first) in STAGE_TIMES.items():
        steady = (tot - first) / (n - 1) if n > 1 else first
        rows.append((k, steady * 1e3, n, first))
    rows.sort(key=lambda r: -(r[1] * max(r[2] - 1, 1)))
    return rows


def _timed(key, method, self, args):
    """`method(self, *args)` timed with the host clock to a
    `torch.cuda.synchronize()` once CUDA is in use (the role of
    `jax.block_until_ready`), recorded in `STAGE_TIMES` under key. The call
    is a `record_function` range "stage <name>", so that a profiler trace
    splits the device time by stage."""
    t0 = time.perf_counter()
    with torch.profiler.record_function(f"stage {key[0]}"):
        out = method(self, *args)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rec = STAGE_TIMES.setdefault(key, [0.0, 0, dt])
    rec[0] += dt
    rec[1] += 1
    return out


def _stage(key=None):
    """A stage method, timed by `_timed` when `stage_timing` is on (read at
    each call) and no flow is fusing; otherwise the method runs alone.
    `key(self, *args)` gives the JAX package's program key of the call
    (default `self._k(name)`)."""

    def wrap(method):
        name = method.__name__

        @functools.wraps(method)
        def stage(self, *args):
            if _FUSING[0] or not config.get_config().stage_timing:
                return method(self, *args)
            return _timed(self._k(name) if key is None else key(self, *args), method, self, args)

        return stage

    return wrap


def _sample(st, fr, nch: int):
    """`nch` challenges from the transcript: `sample_field`'s rejection
    loop, or while fusing its one-round draw (`sample_field_once`), the
    undone lanes of each draw kept in `_UNDONE`."""
    chs = []
    for _ in range(nch):
        if _FUSING[0]:
            st, c, undone = dt.sample_field_once(st, fr)
            _UNDONE.append(undone)
        else:
            st, c = dt.sample_field(st, fr)
        chs.append(c)
    return (st,) + tuple(chs)


def _tree_root_dev(leaf_bytes: torch.Tensor) -> torch.Tensor:
    """Binary Blake2s Merkle root of uint8 [..., k, nbytes] leaves ->
    uint8 [..., 32]; an odd node is promoted unchanged."""
    h = hash_dev.blake2s_bytes(leaf_bytes)
    while h.shape[-2] > 1:
        k = h.shape[-2]
        half = k // 2
        pairs = torch.cat([h[..., 0 : 2 * half : 2, :], h[..., 1 : 2 * half : 2, :]], dim=-1)
        nh = hash_dev.blake2s_bytes(pairs)
        if k % 2:
            nh = torch.cat([nh, h[..., -1:, :]], dim=-2)
        h = nh
    return h[..., 0, :]


def _deck_root_dev(cv: Curve, deck: Ciphertexts) -> torch.Tensor:
    """Merkle root over per-card (c0 || c1) ToBytes leaves: [..., N] -> [..., 32]."""
    both = cv.to_affine(cat_points([deck.c0, deck.c1], dim=0))  # one inversion
    pb = sd.affine_bytes(cv, *both)
    half = pb.shape[0] // 2
    return _tree_root_dev(torch.cat([pb[:half], pb[half:]], dim=-1))


def _commit(cv: Curve, keys: ShuffleKeys, vec_c, r_c) -> PointP:
    """Pedersen commitments sum_i v_i G_i + r H; vectors shorter than the key
    are zero-padded."""
    n = keys.ckg.x.shape[0]
    k = vec_c.shape[-2]
    if k < n:
        vec_c = torch.cat([vec_c, vec_c.new_zeros(vec_c.shape[:-2] + (n - k, vec_c.shape[-1]))], dim=-2)
    return cv.add(fixed_msm(cv, keys.ckg, vec_c), fixed_mul(cv, keys.ckh, r_c))


def _scalar_vecs(vals, n):
    """[..., K, L] values -> [..., K, n, L] vectors (v, 0, ..., 0)."""
    pad = vals.new_zeros(vals.shape[:-1] + (n - 1, vals.shape[-1]))
    return torch.cat([vals[..., None, :], pad], dim=-2)


def _to_aff_many(cv: Curve, *points: PointP):
    """to_aff of several same-batch points with one shared inversion."""
    sizes = [p.x.shape[1] for p in points]
    aff = to_aff(cv, cat_points(points, dim=1))
    out, lo = [], 0
    for s in sizes:
        out.append(AffP(aff.x[:, lo : lo + s], aff.y[:, lo : lo + s], aff.inf[:, lo : lo + s]))
        lo += s
    return out


def _gather_rows(t, pi):
    """t [B, N, L] gathered along N by pi [B, N]."""
    return torch.gather(t, 1, pi[..., None].expand(t.shape))


class StagedShuffle:
    """Prove/verify orchestration for one (curve, m, n) configuration."""

    def __init__(self, cv: Curve, m: int, n: int):
        if m < 2:
            raise ValueError("the Bayer-Groth Hadamard reduction needs m >= 2")
        self.cv = cv
        self.m = m
        self.n = n
        self.N = m * n
        self.fr = cv.fr
        # The zero argument's product terms (k, i, j) and the multi-exp's 2m
        # diagonals (diagonal k takes exponent row j = k - m + i of block
        # i - 1): host lists, with the index tensors made from them once per
        # device by `_const`.
        self._pairs = [
            (k, i, m + 1 + i - k - 1)
            for k in range(2 * m + 1)
            for i in range(m + 1)
            if 1 <= m + 1 + i - k <= m + 1
        ]
        self._diagonals = [
            [(i - 1, k - m + i) for i in range(1, m + 1) if 0 <= k - m + i <= m] for k in range(2 * m)
        ]
        diag_blocks = np.zeros((2 * m, m), np.int64)
        for k, picks in enumerate(self._diagonals):
            diag_blocks[k, : len(picks)] = [blk for blk, _ in picks]
        self._host = {
            "zero_i": torch.tensor([p[1] for p in self._pairs]),
            "zero_j": torch.tensor([p[2] for p in self._pairs]),
            "diag_blocks": torch.as_tensor(diag_blocks),
            "one_to_N": cv.fr.small_int_limbs(np.arange(1, self.N + 1), "cpu"),
        }
        self._consts: dict = {}

    def _const(self, name: str, device) -> torch.Tensor:
        """`_host[name]` on `device`, copied once: a copy from the host
        cannot be captured in a CUDA graph."""
        key = (name, torch.device(device))
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = self._host[name].to(device)
        return t

    def _fused(self, name: str, flow, *args):
        """The flow fused (`fused.py`): one CUDA graph on the card, eager on
        the CPU, with one-round challenge draws; a draw that leaves a lane
        undone reruns the flow staged."""
        from . import fused  # imported here: fused.py imports this module

        return fused.run(self, name, flow, args)

    def _k(self, name, *extra):
        """The JAX package's program key of a stage (`STAGE_TIMES`)."""
        return (name, self.cv.name, self.m, self.n) + extra

    # ------------------------------------------------------------ stages
    @_stage()
    def stmt(self, keys, din: Ciphertexts, dout: Ciphertexts):
        cv, m, n = self.cv, self.m, self.n
        B = din.c0.x.shape[0]
        dev = din.c0.x.device
        st = dt.init(SHUFFLE_RNG_SEED, (B,), dev)
        stacked = Ciphertexts(
            stack_points([din.c0, dout.c0], dim=1), stack_points([din.c1, dout.c1], dim=1)
        )
        roots = _deck_root_dev(cv, stacked)  # [B, 2, 32]
        blob = sd.concat_bytes(
            sd.points_blob(cv, table_base(keys.pk)),
            roots[:, 0],
            roots[:, 1],
            sd.u64_le_bytes(m, device=dev),
            sd.u64_le_bytes(n, device=dev),
        )
        return dt.absorb(st, blob)

    @_stage(lambda s, keys, vecs_c, rs_c: ("commit", s.cv.name, s.n, vecs_c.shape[-3]))
    def commit(self, keys, vecs_c, rs_c) -> AffP:
        return to_aff(self.cv, _commit(self.cv, keys, vecs_c, rs_c))

    @_stage(lambda s, st, aff, nch: s._k("abs_pts", aff.x.shape[1], nch))
    def abs_pts(self, st, aff: AffP, nch: int):
        return _sample(dt.absorb(st, aff_blob(self.cv, aff)), self.fr, nch)

    @_stage(lambda s, st, data, nch: s._k("abs_const", data, nch))
    def abs_const(self, st, data: bytes, nch: int):
        return _sample(dt.absorb(st, sd.const_bytes(data, st.widx.shape, st.widx.device)), self.fr, nch)

    @_stage()
    def abs_me(self, st, pts_aff: AffP, e0: AffP, e1: AffP):
        eb = torch.cat([aff_bytes(self.cv, e0), aff_bytes(self.cv, e1)], dim=-1)  # [B, 2m, 2pb]
        return _sample(dt.absorb(st, sd.concat_bytes(aff_blob(self.cv, pts_aff), eb.flatten(-2))), self.fr, 1)

    @_stage()
    def make_a(self, pi):
        B = pi.shape[0]
        a = torch.zeros((B, self.N, self.fr.L), dtype=torch.int32, device=pi.device)
        a[..., 0] = (pi + 1).to(torch.int32)
        return a.reshape(B, self.m, self.n, self.fr.L)

    @_stage()
    def make_b(self, x_m, pi):
        fr = self.fr
        b_m = _gather_rows(fr.powers(x_m, self.N), pi)
        return fr.from_mont(b_m).reshape(pi.shape[0], self.m, self.n, fr.L)

    @_stage()
    def prod_prep(self, x_m, y_m, z_m, pi, r_c, s_c, prod_s_c):
        m, n, N, fr = self.m, self.n, self.N, self.fr
        B = pi.shape[0]
        dev = pi.device
        a_c = torch.zeros((B, N, fr.L), dtype=torch.int32, device=dev)
        a_c[..., 0] = (pi + 1).to(torch.int32)
        a_m = fr.to_mont(a_c)
        xpow = fr.powers(x_m, N)
        b_m = _gather_rows(xpow, pi)
        zb = z_m[:, None, :]
        dz_m = fr.sub(fr.add(fr.mont_mul(y_m[:, None, :], a_m), b_m), zb)
        t_m = fr.add(fr.mont_mul(y_m[:, None, :], fr.to_mont(r_c)), fr.to_mont(s_c))  # [B, m, L]
        i_m = fr.to_mont(self._const("one_to_N", dev))
        terms = fr.sub(fr.add(fr.mont_mul(y_m[:, None, :], i_m), xpow), zb)
        v_m = fr.prod_mod(terms, axis=1)
        dz_rows = dz_m.reshape(B, m, n, fr.L)
        b_vec_m = fr.prod_mod(dz_rows, axis=1)  # [B, n, L]
        cpb_vec_c = fr.from_mont(b_vec_m)[:, None]  # [B, 1, n, L]
        prod_s_m = fr.to_mont(prod_s_c)
        return dz_rows, t_m, b_vec_m, v_m, cpb_vec_c, prod_s_m

    @_stage()
    def had_mids(self, dz_rows_m, t_m, prod_s_m, had_sB_c):
        fr = self.fr
        B_m = fr.prefix_prod(dz_rows_m, axis=1)  # partial products B_i
        s_B_m = torch.cat([t_m[:, :1], fr.to_mont(had_sB_c), prod_s_m[:, None]], dim=1)
        return B_m, s_B_m, fr.from_mont(B_m[:, 1:-1]), fr.from_mont(s_B_m[:, 1:-1])

    @_stage()
    def had_prep(self, hx_m, B_m, s_B_m, dz_rows_m, t_m):
        m, n, fr = self.m, self.n, self.fr
        B = hx_m.shape[0]
        xi = fr.powers(hx_m, m + 1, start=0)  # [B, m+1, L]
        d_rows = fr.mont_mul(B_m[:, : m - 1], xi[:, 1:m, None, :])
        d_sum = fr.sum_mod(fr.mont_mul(B_m[:, 1:m], xi[:, 1:m, None, :]), axis=1)
        t_sum = fr.sum_mod(fr.mont_mul(xi[:, 1:m], s_B_m[:, 1:m]), axis=1)
        A_rows = torch.cat([d_rows, d_sum[:, None]], dim=1)
        R_rows = torch.cat([fr.mont_mul(xi[:, 1:m], s_B_m[:, : m - 1]), t_sum[:, None]], dim=1)
        minus1 = fr.neg(fr.ones((B, 1, n), hx_m.device))
        B_rows = torch.cat([dz_rows_m[:, 1:], minus1], dim=1)
        S_rows = torch.cat([t_m[:, 1:], fr.zeros((B, 1), hx_m.device)], dim=1)
        return A_rows, R_rows, B_rows, S_rows

    @_stage()
    def zero_prep(self, hy_m, A_rows, R_rows, B_rows, S_rows, a0_c, r0_c, bm1_c, sm1_c, t_c):
        m, n, fr = self.m, self.n, self.fr
        a0 = fr.to_mont(a0_c)
        r0 = fr.to_mont(r0_c)
        bm1 = fr.to_mont(bm1_c)
        sm1 = fr.to_mont(sm1_c)
        t = fr.to_mont(t_c).clone()  # [B, 2m+1, L]
        t[:, m + 1] = 0
        A = torch.cat([a0[:, None], A_rows], dim=1)  # rows 0..m
        Bv = torch.cat([B_rows, bm1[:, None]], dim=1)  # rows 1..m+1
        R = torch.cat([r0[:, None], R_rows], dim=1)
        S = torch.cat([S_rows, sm1[:, None]], dim=1)
        ypow = fr.powers(hy_m, n)  # [B, n, L]
        dev = hy_m.device
        prods = fr.mont_mul(A[:, self._const("zero_i", dev)], Bv[:, self._const("zero_j", dev)])  # [B, P, n, L]
        terms = fr.sum_mod(fr.mont_mul(prods, ypow[:, None]), axis=2)  # [B, P, L]
        d = []
        for k in range(2 * m + 1):
            sel = [idx for idx, p in enumerate(self._pairs) if p[0] == k]
            acc = terms[:, sel[0]]
            for s_ in sel[1:]:
                acc = fr.add(acc, terms[:, s_])
            d.append(acc)
        d_m = torch.stack(d, dim=1)  # [B, 2m+1, L]
        vecs_c = torch.cat(
            [fr.from_mont(a0)[:, None], fr.from_mont(bm1)[:, None], _scalar_vecs(fr.from_mont(d_m), n)],
            dim=1,
        )  # [B, 2m+3, n, L]
        rs_c = torch.cat([fr.from_mont(r0)[:, None], fr.from_mont(sm1)[:, None], fr.from_mont(t)], dim=1)
        return vecs_c, rs_c, A, Bv, R, S, t

    @_stage()
    def zero_open(self, zx_m, A, Bv, R, S, t):
        m, fr = self.m, self.fr
        xi = fr.powers(zx_m, 2 * m + 2, start=0)
        co = xi[:, : m + 1]
        rev = torch.flip(co, dims=[1])
        opens = (
            fr.sum_mod(fr.mont_mul(A, co[..., None, :]), axis=1),
            fr.sum_mod(fr.mont_mul(R, co), axis=1),
            fr.sum_mod(fr.mont_mul(Bv, rev[..., None, :]), axis=1),
            fr.sum_mod(fr.mont_mul(S, rev), axis=1),
            fr.sum_mod(fr.mont_mul(t, xi[:, : 2 * m + 1]), axis=1),
        )
        return tuple(fr.from_mont(v) for v in opens)

    @_stage()
    def svp_prep(self, b_vec_m, d_c, rd_c, delta_c, s1_c, sx_c):
        n, fr = self.n, self.fr
        B = b_vec_m.shape[0]
        d = fr.to_mont(d_c)
        delta = fr.to_mont(delta_c).clone()
        delta[:, 0] = d[:, 0]
        delta[:, n - 1] = 0
        bpart = fr.prefix_prod(b_vec_m, axis=1)
        cdel = fr.neg(fr.mont_mul(delta[:, :-1], d[:, 1:]))  # [B, n-1]
        cDel = fr.sub(
            fr.sub(delta[:, 1:], fr.mont_mul(b_vec_m[:, 1:], delta[:, :-1])),
            fr.mont_mul(bpart[:, :-1], d[:, 1:]),
        )
        zpad = fr.zeros((B, 1), b_vec_m.device)
        vecs_c = torch.stack(
            [d_c, torch.cat([fr.from_mont(cdel), zpad], 1), torch.cat([fr.from_mont(cDel), zpad], 1)],
            dim=1,
        )  # [B, 3, n, L]
        rs_c = torch.stack([rd_c, s1_c, sx_c], dim=1)
        return vecs_c, rs_c, bpart, d, delta

    @_stage()
    def svp_open(self, svx_m, b_vec_m, prod_s_m, bpart, d, delta, rd_c, s1_c, sx_c):
        fr = self.fr
        x = svx_m[:, None, :]
        a_t = fr.add(fr.mont_mul(x, b_vec_m), d)
        b_t = fr.add(fr.mont_mul(x, bpart), delta)
        r_t = fr.add(fr.mont_mul(svx_m, prod_s_m), fr.to_mont(rd_c))
        s_t = fr.add(fr.mont_mul(svx_m, fr.to_mont(sx_c)), fr.to_mont(s1_c))
        return tuple(fr.from_mont(v) for v in (a_t, r_t, b_t, s_t))

    @_stage()
    def me_prep(self, keys, dout, x_m, pi, s_c, rho_c, a0_c, r0_c, b_c, sk_c, tau_c):
        cv, m, n, N, fr = self.cv, self.m, self.n, self.N, self.fr
        B = pi.shape[0]
        dev = pi.device
        L = fr.L
        b_m = _gather_rows(fr.powers(x_m, N), pi)  # [B, N, L]
        rho_star = fr.neg(fr.sum_mod(fr.mont_mul(fr.to_mont(rho_c), b_m), axis=1))
        a0 = fr.to_mont(a0_c)
        b_k = fr.to_mont(b_c).clone()
        s_k = fr.to_mont(sk_c).clone()
        tau_k = fr.to_mont(tau_c).clone()
        b_k[:, m] = 0
        s_k[:, m] = 0
        tau_k[:, m] = rho_star
        rows = torch.cat([a0[:, None], b_m.reshape(B, m, n, L)], dim=1)  # exponent rows 0..m
        r_full_m = torch.cat([fr.to_mont(r0_c)[:, None], fr.to_mont(s_c)], dim=1)  # [B, m+1, L]

        # blinds E(b_k G'; tau_k)
        tau_cc = fr.from_mont(tau_k)
        bl0 = fixed_mul(cv, keys.gen, tau_cc)
        bl1 = cv.add(fixed_mul(cv, keys.sgen, fr.from_mont(b_k)), fixed_mul(cv, keys.pk, tau_cc))

        # the 2m diagonals of both ciphertext components as one MSM [B, 4m, m*n]
        zero_row = torch.zeros((B, n, L), dtype=torch.int32, device=dev)
        scal_rows = []
        for picks in self._diagonals:
            srows = [fr.from_mont(rows[:, j]) for _, j in picks]
            srows += [zero_row] * (m - len(srows))
            scal_rows.append(torch.cat(srows, dim=1))
        scal = torch.stack(scal_rows, dim=1)  # [B, 2m, m*n, L]
        idx = self._const("diag_blocks", dev)
        fqL = dout.c0.x.shape[-1]

        def diag(P: PointP) -> PointP:
            return map_point(lambda q: q.reshape(B, m, n, fqL)[:, idx].reshape(B, 2 * m, m * n, fqL), P)

        gboth = cat_points([diag(dout.c0), diag(dout.c1)], dim=1)
        dboth = msm_mod.msm(cv, gboth, torch.cat([scal, scal], dim=1), engine="lanes")
        e0 = cv.add(bl0, map_point(lambda q: q[:, : 2 * m], dboth))
        e1 = cv.add(bl1, map_point(lambda q: q[:, 2 * m :], dboth))
        e0a, e1a = _to_aff_many(cv, e0, e1)

        vecs_c = torch.cat([a0_c[:, None], _scalar_vecs(fr.from_mont(b_k), n)], dim=1)  # [B, 1+2m, n, L]
        rs_c = torch.cat([r0_c[:, None], fr.from_mont(s_k)], dim=1)
        return e0a, e1a, vecs_c, rs_c, rows, r_full_m, b_k, s_k, tau_k

    @_stage()
    def me_open(self, mex_m, rows, r_full_m, b_k, s_k, tau_k):
        m, fr = self.m, self.fr
        xj = fr.powers(mex_m, 2 * m, start=0)  # [B, 2m, L]
        co = xj[:, : m + 1]
        opens = (
            fr.sum_mod(fr.mont_mul(rows, co[..., None, :]), axis=1),
            fr.sum_mod(fr.mont_mul(r_full_m, co), axis=1),
            fr.sum_mod(fr.mont_mul(b_k, xj), axis=1),
            fr.sum_mod(fr.mont_mul(s_k, xj), axis=1),
            fr.sum_mod(fr.mont_mul(tau_k, xj), axis=1),
        )
        return tuple(fr.from_mont(v) for v in opens)

    # ------------------------------------------------------------ prove
    def prove(
        self,
        keys: ShuffleKeys,
        deck_in: Ciphertexts,
        deck_out: Ciphertexts,
        pi: torch.Tensor,  # int [B, N]
        rho_c: torch.Tensor,  # canonical [B, N, L]
        rand: ShuffleRand,  # leaves with a leading [B]
    ) -> ShuffleProofDev:
        """Batch-first prove: the stage flow, fused when 0 < B <=
        `fuse_b_max` (`MPTPU_FUSE_B`), as `mental_poker_tpu/arguments/staged.py:670`."""
        B = pi.shape[0]
        if 0 < B <= config.get_config().fuse_b_max:
            return self._fused("fused_prove", self._prove_flow, keys, deck_in, deck_out, pi, rho_c, rand)
        return self._prove_flow(keys, deck_in, deck_out, pi, rho_c, rand)

    def _prove_flow(self, keys, deck_in, deck_out, pi, rho_c, rand) -> ShuffleProofDev:
        cv, m, fr = self.cv, self.m, self.fr
        pi = pi.long()
        st = self.stmt(keys, deck_in, deck_out)

        c_a = self.commit(keys, self.make_a(pi), rand.r)
        st, x = self.abs_pts(st, c_a, 1)

        c_b = self.commit(keys, self.make_b(x, pi), rand.s)
        st, y, z = self.abs_pts(st, c_b, 2)

        dz_rows, t_m, b_vec_m, v_m, cpb_vec_c, prod_s_m = self.prod_prep(
            x, y, z, pi, rand.r, rand.s, rand.prod_s
        )
        c_pb = self.commit(keys, cpb_vec_c, rand.prod_s[:, None])
        st = self.abs_pts(st, c_pb, 0)[0]

        B_m, s_B_m, mid_vecs_c, mid_rs_c = self.had_mids(dz_rows, t_m, prod_s_m, rand.had_sB)
        if m > 2:
            c_mid = self.commit(keys, mid_vecs_c, mid_rs_c)
            st, hx, hy = self.abs_pts(st, c_mid, 2)
        else:
            B = pi.shape[0]
            empty = fr.zeros((B, 0), pi.device)
            c_mid = AffP(empty, empty.clone(), torch.zeros((B, 0), dtype=torch.bool, device=pi.device))
            st, hx, hy = self.abs_const(st, _NO_MID, 2)

        A_rows, R_rows, B_rows, S_rows = self.had_prep(hx, B_m, s_B_m, dz_rows, t_m)
        zvecs, zrs, A, Bv, R, S, t_full = self.zero_prep(
            hy, A_rows, R_rows, B_rows, S_rows,
            rand.zero_a0, rand.zero_r0, rand.zero_bm1, rand.zero_sm1, rand.zero_t,
        )
        c_zero = self.commit(keys, zvecs, zrs)
        st, zx = self.abs_pts(st, c_zero, 1)
        za, zr, zb, zs, zt = self.zero_open(zx, A, Bv, R, S, t_full)

        svecs, srs, bpart, d_m, delta_m = self.svp_prep(
            b_vec_m, rand.svp_d, rand.svp_rd, rand.svp_delta, rand.svp_s1, rand.svp_sx
        )
        c_svp = self.commit(keys, svecs, srs)
        st, svx = self.abs_pts(st, c_svp, 1)
        sa, sr, sb, ss = self.svp_open(
            svx, b_vec_m, prod_s_m, bpart, d_m, delta_m, rand.svp_rd, rand.svp_s1, rand.svp_sx
        )

        e0a, e1a, mvecs, mrs, rows, r_full_m, b_k, s_k, tau_k = self.me_prep(
            keys, deck_out, x, pi, rand.s, rho_c,
            rand.me_a0, rand.me_r0, rand.me_b, rand.me_s, rand.me_tau,
        )
        c_me = self.commit(keys, mvecs, mrs)
        st, mex = self.abs_me(st, c_me, e0a, e1a)
        ma, mr, mb, ms, mtau = self.me_open(mex, rows, r_full_m, b_k, s_k, tau_k)

        rg = lambda aff, i, j: AffP(aff.x[:, i:j], aff.y[:, i:j], aff.inf[:, i:j])
        return ShuffleProofDev(
            c_a=c_a,
            c_b=c_b,
            product=ProductProofDev(
                c_b=slice_aff(c_pb, 0),
                hadamard=HadamardProofDev(
                    c_B_mid=c_mid,
                    zero=ZeroProofDev(
                        c_a0=slice_aff(c_zero, 0),
                        c_bm1=slice_aff(c_zero, 1),
                        c_d=rg(c_zero, 2, 2 * m + 3),
                        a=za, r=zr, b=zb, s=zs, t=zt,
                    ),
                ),
                svp=SVPProofDev(
                    c_d=slice_aff(c_svp, 0),
                    c_delta=slice_aff(c_svp, 1),
                    c_Delta=slice_aff(c_svp, 2),
                    a_tilde=sa, r_tilde=sr, b_tilde=sb, s_tilde=ss,
                ),
            ),
            multi_exp=MultiExpProofDev(
                c_a0=slice_aff(c_me, 0),
                c_b=rg(c_me, 1, 1 + 2 * m),
                e0=e0a, e1=e1a,
                a=ma, r=mr, b=mb, s=ms, tau=mtau,
            ),
        )

    # ------------------------------------------------------------ verify
    @_stage()
    def ver_prep(self, x, y, z, hy, za, zr, zb, zs, zt, sa, sr, sb, ss, svx, ma, mr, mb, ms):
        n, N, fr = self.n, self.N, self.fr
        B = x.shape[0]
        dev = x.device
        xpow = fr.powers(x, N)
        i_m = fr.to_mont(self._const("one_to_N", dev))
        zb_ = z[:, None, :]
        v_m = fr.prod_mod(fr.sub(fr.add(fr.mont_mul(y[:, None, :], i_m), xpow), zb_), axis=1)
        ypow = fr.powers(hy, n)
        ab_y = fr.sum_mod(fr.mont_mul(fr.mont_mul(fr.to_mont(za), fr.to_mont(zb)), ypow), axis=1)
        a_t = fr.to_mont(sa)
        b_t = fr.to_mont(sb)
        e = fr.sub(fr.mont_mul(svx[:, None, :], b_t[:, 1:]), fr.mont_mul(b_t[:, :-1], a_t[:, 1:]))
        zpad = fr.zeros((B, 1), dev)
        minus1 = fr.from_mont(fr.neg(fr.ones((B, n), dev)))
        mz = fr.from_mont(fr.neg(z[:, None, :].expand(B, n, fr.L)))
        zero_l = fr.zeros((B,), dev)
        zrows = fr.zeros((B, n - 1), dev)
        vecs_c = torch.stack(
            [
                za,
                zb,
                torch.cat([fr.from_mont(ab_y)[:, None], zrows], dim=1),
                sa,
                torch.cat([fr.from_mont(e), zpad], dim=1),
                ma,
                torch.cat([mb[:, None], zrows], dim=1),
                mz,
                minus1,
            ],
            dim=1,
        )  # [B, 9, n, L]
        rs_c = torch.stack([zr, zs, zt, sr, ss, mr, ms, zero_l, zero_l], dim=1)
        svp_flag = fr.eq(b_t[:, 0], a_t[:, 0]) & fr.eq(b_t[:, -1], fr.mont_mul(svx, v_m))
        return vecs_c, rs_c, svp_flag, v_m

    @_stage()
    def coeffs(self, x, y, hx, zx, svx, mex, ma):
        m, fr = self.m, self.fr
        B = x.shape[0]
        mexpow = fr.powers(mex, max(m, 1), start=0)  # mex^0..mex^(m-1)
        # me rhs_e scalars: row i-1 carries mex^(m-i) * a, i = 1..m
        mescal = fr.mont_mul(torch.flip(mexpow[:, :m], dims=[1])[..., None, :], fr.to_mont(ma)[:, None])
        return dict(
            one=fr.ones((B,), x.device),
            y=y,
            hxi=fr.powers(hx, m + 1, start=0),
            zxi=fr.powers(zx, 2 * m + 2, start=0),
            xj=fr.powers(mex, 2 * m, start=0),
            mescal=fr.from_mont(mescal.reshape(B, -1, fr.L)),
        )

    def _combo_rows(self, rows) -> PointP:
        """Rows of (points [B, k] PointP, coefficients [B, k, L]) padded to
        the widest row's power-of-two width -> one `combo` -> PointP [B, Q]."""
        width = max(r[1].shape[1] for r in rows)
        P = 1 if width <= 1 else 1 << (width - 1).bit_length()
        pts, cs = [], []
        for pt, co in rows:
            k = co.shape[1]
            if k < P:
                pt = map_point(lambda q: torch.cat([q, q.new_zeros((q.shape[0], P - k, q.shape[-1]))], 1), pt)
                co = torch.cat([co, co.new_zeros((co.shape[0], P - k, co.shape[-1]))], 1)
            pts.append(pt)
            cs.append(co)
        return self.combo(stack_points(pts, dim=1), torch.stack(cs, dim=1))

    @_stage(lambda s, pts, cs: s._k("combo", cs.shape[1], cs.shape[2]))
    def combo(self, pts: PointP, cs) -> PointP:
        """Q per-statement MSMs of P points: points [B, Q, P], coefficients
        [B, Q, P, L] -> PointP [B, Q]."""
        return msm_mod.msm(self.cv, pts, cs)

    @_stage(lambda s, *args: s._k("flags", DEBUG_FLAGS))
    def flags(self, keys, lhs_aff, rhs_pts, cipher_pts, mb_c, mtau_c, czm1_aff, cbm_aff, em0_aff, em1_aff, svp_flag):
        cv = self.cv
        lhs = aff_to_proj(cv, lhs_aff)
        ok_pairs = cv.eq(lhs, rhs_pts)  # [B, 7]
        t0, t1, le0, le1, rp0, rp1 = (map_point(lambda q: q[:, i], cipher_pts) for i in range(6))
        bl0 = fixed_mul(cv, keys.gen, mtau_c)
        bl1 = cv.add(fixed_mul(cv, keys.sgen, mb_c), fixed_mul(cv, keys.pk, mtau_c))
        ok_e = cv.eq(le0, cv.add(bl0, rp0)) & cv.eq(le1, cv.add(bl1, rp1))
        ok_em = cv.eq(aff_to_proj(cv, em0_aff), t0) & cv.eq(aff_to_proj(cv, em1_aff), t1)
        ok_idzero = cv.is_identity(aff_to_proj(cv, czm1_aff))
        ok_idme = cv.is_identity(aff_to_proj(cv, cbm_aff))
        had_ok = ok_pairs[:, 0] & ok_pairs[:, 1] & ok_pairs[:, 2] & ok_idzero
        svp_ok = ok_pairs[:, 3] & ok_pairs[:, 4] & svp_flag
        me_ok = ok_pairs[:, 5] & ok_pairs[:, 6] & ok_e & ok_em & ok_idme
        checks = ShuffleChecks(had_ok, svp_ok, me_ok)
        if DEBUG_FLAGS:
            return checks, {
                "pairs": ok_pairs, "e": ok_e, "em": ok_em,
                "idzero": ok_idzero, "idme": ok_idme, "svp": svp_flag,
            }
        return checks

    def verify(
        self,
        keys: ShuffleKeys,
        deck_in: Ciphertexts,
        deck_out: Ciphertexts,
        proof: ShuffleProofDev,
    ) -> ShuffleChecks:
        """Batch-first verify; fused at 0 < B <= `fuse_b_max`, as
        `mental_poker_tpu/arguments/staged.py:969`."""
        B = proof.c_a.x.shape[0]
        if 0 < B <= config.get_config().fuse_b_max:
            return self._fused("fused_verify", self._verify_flow, keys, deck_in, deck_out, proof)
        return self._verify_flow(keys, deck_in, deck_out, proof)

    def _verify_flow(self, keys, deck_in, deck_out, proof) -> ShuffleChecks:
        cv, m, N, fr = self.cv, self.m, self.N, self.fr

        # ---- transcript replay
        st = self.stmt(keys, deck_in, deck_out)
        st, x = self.abs_pts(st, proof.c_a, 1)
        st, y, z = self.abs_pts(st, proof.c_b, 2)
        pb = proof.product.c_b
        st = self.abs_pts(st, cat_affs(pb), 0)[0]
        if m > 2:
            st, hx, hy = self.abs_pts(st, proof.product.hadamard.c_B_mid, 2)
        else:
            st, hx, hy = self.abs_const(st, _NO_MID, 2)
        zproof = proof.product.hadamard.zero
        st, zx = self.abs_pts(st, cat_affs(zproof.c_a0, zproof.c_bm1, zproof.c_d), 1)
        sproof = proof.product.svp
        st, svx = self.abs_pts(st, cat_affs(sproof.c_d, sproof.c_delta, sproof.c_Delta), 1)
        me = proof.multi_exp
        st, mex = self.abs_me(st, cat_affs(me.c_a0, me.c_b), me.e0, me.e1)

        # ---- deferred algebra
        vecs_c, rs_c, svp_flag, _ = self.ver_prep(
            x, y, z, hy,
            zproof.a, zproof.r, zproof.b, zproof.s, zproof.t,
            sproof.a_tilde, sproof.r_tilde, sproof.b_tilde, sproof.s_tilde, svx,
            me.a, me.r, me.b, me.s,
        )
        lhs = self.commit(keys, vecs_c, rs_c)  # [B, 9]
        lhs7 = AffP(lhs.x[:, :7], lhs.y[:, :7], lhs.inf[:, :7])
        cmz_p = aff_to_proj(cv, slice_aff(lhs, 7))
        cm1_p = aff_to_proj(cv, slice_aff(lhs, 8))

        co = self.coeffs(x, y, hx, zx, svx, mex, me.a)
        one_c = fr.from_mont(co["one"])
        y_c = fr.from_mont(co["y"])
        hxi_c = fr.from_mont(co["hxi"])
        zxi_c = fr.from_mont(co["zxi"])
        xj_c = fr.from_mont(co["xj"])
        svx_c = fr.from_mont(svx)

        proj = lambda a: aff_to_proj(cv, a)
        ca_p, cb_p, cpb_p = proj(proof.c_a), proj(proof.c_b), proj(pb)
        mid_p = proj(proof.product.hadamard.c_B_mid)
        ca0z_p, cbm1_p, cd_p = proj(zproof.c_a0), proj(zproof.c_bm1), proj(zproof.c_d)
        sd_p, sdel_p, sDel_p = proj(sproof.c_d), proj(sproof.c_delta), proj(sproof.c_Delta)
        mea0_p, mecb_p, e0_p, e1_p = proj(me.c_a0), proj(me.c_b), proj(me.e0), proj(me.e1)

        at = lambda P, i: map_point(lambda q: q[:, i], P)
        row = lambda pts, cs: (stack_points(pts, dim=1), torch.stack(cs, dim=1))

        # layer 1: product-argument statement commitments c_d[k] = y c_a[k] + c_b[k] + c_mz
        l1 = self._combo_rows([row([at(ca_p, k), at(cb_p, k), cmz_p], [y_c, one_c, one_c]) for k in range(m)])

        # layer 2: Hadamard-reduced commitments c_D_i = hx^i c_B[i-1], c_Dsum = sum hx^i c_B[i]
        cB = [at(l1, 0)] + [at(mid_p, i) for i in range(m - 2)] + [cpb_p]
        l2_rows = [row([cB[i - 1]], [hxi_c[:, i]]) for i in range(1, m)]
        l2_rows.append(row([cB[i] for i in range(1, m)], [hxi_c[:, i] for i in range(1, m)]))
        l2 = self._combo_rows(l2_rows)

        # layer 3: the right-hand side of every lhs == rhs check
        c_a_z = [at(l2, i) for i in range(m)]
        c_b_z = [at(l1, i) for i in range(1, m)] + [cm1_p]
        rhs = self._combo_rows([
            row([ca0z_p] + c_a_z, [zxi_c[:, i] for i in range(m + 1)]),
            row(c_b_z + [cbm1_p], [zxi_c[:, m + 1 - j] for j in range(1, m + 2)]),
            (cd_p, zxi_c[:, : 2 * m + 1]),
            row([cpb_p, sd_p], [svx_c, one_c]),
            row([sDel_p, sdel_p], [svx_c, one_c]),
            row([mea0_p] + [at(cb_p, i) for i in range(m)], [xj_c[:, i] for i in range(m + 1)]),
            (mecb_p, xj_c[:, : 2 * m]),
        ])  # [B, 7]

        # ciphertext combos: the N-wide deck rows (T and the me rhs pair) and
        # the 2m-wide blind rows (lhs_e)
        xpow_c = fr.from_mont(fr.powers(x, N))
        mescal = co["mescal"]  # [B, m*n, L]
        deckc = self.combo(
            stack_points([deck_in.c0, deck_in.c1, deck_out.c0, deck_out.c1], dim=1),
            torch.stack([xpow_c, xpow_c, mescal, mescal], dim=1),
        )  # [B, 4]: T0, T1, rP0, rP1
        ec = self._combo_rows([(e0_p, xj_c[:, : 2 * m]), (e1_p, xj_c[:, : 2 * m])])
        cipher = cat_points(
            [map_point(lambda q: q[:, :2], deckc), ec, map_point(lambda q: q[:, 2:], deckc)], dim=1
        )  # T0, T1, lE0, lE1, rP0, rP1

        return self.flags(
            keys, lhs7, rhs, cipher, me.b, me.tau,
            slice_aff(zproof.c_d, m + 1), slice_aff(me.c_b, m),
            slice_aff(me.e0, m), slice_aff(me.e1, m), svp_flag,
        )
