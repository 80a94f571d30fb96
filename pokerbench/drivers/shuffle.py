"""Traffic of the shuffle cells: a closed loop of calls, each proving and
verifying a batch of B decks through the port's entry points.

Set-up (from the seed): the public parameters (ElGamal generator, an
aggregate key sk G, n Pedersen generators, the blinding and the shuffle
generator) as host points, their window tables (`device_api.
keys_from_points`); `statements` sets of B input decks whose cards are sums
of two pool points, each with a permutation and remask factors, and its
output deck (permuted, then remasked with `fixed_mul` on the tables). The
runtime config fixes `msm_nc`, the fixed-base window and `fuse_b_max`.

A call takes the next statement set, draws fresh prover randomness
(`device_api.sample_shuffle_rand`, the program's seeded host draws), proves
(`device_api.prove_shuffle`), verifies (`device_api.verify_shuffle`), counts
the decks the verifier rejected on the device and keeps the proofs of a
few decks drawn from the seed; then it synchronises.

After the window the reference verifier (Python integers) judges a sample
of the kept proofs against statements it works out again from the seed's
points, permutations and factors; and the port's verifier is given the last
call's proofs against a tampered statement (card 0 of the output deck
replaced by card 0 of the input deck in half the decks, or in the one deck
of a batch of one), which it must reject exactly there.
"""

from __future__ import annotations

import numpy as np
import torch

from mental_poker_tpu_torch import config as pconfig
from mental_poker_tpu_torch.arguments import device_api, fused
from mental_poker_tpu_torch.arguments.device import tree_map
from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
from mental_poker_tpu_torch.ops.curve import map_point, stark_curve
from mental_poker_tpu_torch.ops.msm import fixed_mul
from mental_poker_tpu_torch.utils.rand import GameRng

from .. import inputs
from ..inputs import Draws
from ..reference import curve as ec
from ..reference import shuffle as ref

CURVES = {"stark": stark_curve}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _cards(deck: Ciphertexts, idx) -> Ciphertexts:
    return Ciphertexts(*(map_point(lambda t: t[idx], c) for c in deck))


class Driver:
    unit = "decks"

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.device = torch.device(device)
        self.m, self.n = conf["m"], conf["n"]
        N = self.N = self.m * self.n
        B = self.B = traffic["batch"]
        S = self.S = traffic["statements"]
        self.traffic = traffic
        self.seed = seed
        pconfig.set_config(pconfig.RuntimeConfig(
            msm_nc=conf["msm_nc"], fixed_window_bits=conf["fixed_window_bits"], fuse_b_max=traffic["fuse_b_max"]))
        cv = self.cv = CURVES[conf["curve"]]()

        draws = Draws(seed, "shuffle")
        gen, ck_h, sgen, *ck_g = draws.points(self.n + 3)
        sk = inputs.limbs_int(draws.scalars(()))
        pk = ec.mul(sk, gen)
        self.params = dict(gen=gen, pk=pk, ck_g=ck_g, ck_h=ck_h, sgen=sgen)
        self.pool = draws.points(traffic["pool"])
        self.card_idx = draws.indices((S, B, N, 2, 2), len(self.pool))
        self.pi = draws.permutations(S * B, N).reshape(S, B, N)
        self.rho = draws.scalars((S, B, N))

        dev = self.device
        self.keys = device_api.keys_from_points(cv, gen, pk, ck_g, ck_h, sgen, c=conf["fixed_window_bits"], device=dev)
        pool = cv.from_host_points(self.pool, dev)
        idx = torch.as_tensor(self.card_idx, device=dev)
        deck = Ciphertexts(*(cv.add(map_point(lambda t: t[idx[..., c, 0]], pool),
                                    map_point(lambda t: t[idx[..., c, 1]], pool)) for c in (0, 1)))
        pi = torch.as_tensor(self.pi, device=dev)
        rho = torch.as_tensor(self.rho, device=dev)
        take = pi[..., None].expand(S, B, N, cv.fq.L)
        permuted = Ciphertexts(*(map_point(lambda t: torch.gather(t, 2, take), c) for c in deck))
        out = Ciphertexts(cv.add(permuted.c0, fixed_mul(cv, self.keys.gen, rho)),
                          cv.add(permuted.c1, fixed_mul(cv, self.keys.pk, rho)))
        self.statements = [(_cards(deck, s), _cards(out, s), pi[s], rho[s]) for s in range(S)]
        self.rng = GameRng(seed)
        self.lane_draws = Draws(seed, "lanes")
        self.rejected = torch.zeros((), dtype=torch.int64, device=dev)
        self.kept = []  # (call, statement set, lanes, the lanes' proofs)
        self.last = None
        self.fixed_bases = {}
        _sync(dev)

    # ------------------------------------------------------------ the calls
    def prove_verify(self, s: int):
        cv, m, n = self.cv, self.m, self.n
        deck_in, deck_out, pi, rho = self.statements[s]
        rand = device_api.sample_shuffle_rand(self.rng, m, n, cv.fr.L, cv.host.order, batch=self.B, device=self.device)
        proof = device_api.prove_shuffle(cv, m, n, self.keys, deck_in, deck_out, pi, rho, rand)
        checks = device_api.verify_shuffle(cv, m, n, self.keys, deck_in, deck_out, proof)
        return proof, checks

    def warm(self) -> None:
        """The window's shapes: a call (which captures the fused graphs) and
        a second one (the first replays)."""
        for s in range(min(2, self.S)):
            self.prove_verify(s)
        self.rejected.zero_()
        _sync(self.device)

    def call(self, i: int) -> int:
        s = i % self.S
        proof, checks = self.prove_verify(s)
        ok = checks.hadamard & checks.svp & checks.multi_exp
        self.rejected += (~ok).sum()
        lanes = self.lane_draws.choose(self.B, self.traffic["kept_per_call"])
        lanes_d = torch.as_tensor(lanes, device=self.device)
        self.kept.append((i, s, lanes, tree_map(lambda t: t[lanes_d], proof)))
        self.last = (s, proof)
        _sync(self.device)
        return self.B

    def trace_call(self) -> None:
        self.prove_verify(0)

    def counters(self) -> dict:
        return {"fused_misses": fused.FUSED_MISSES,
                "fused_capture_s": sum(c.capture_s for c in fused.GRAPHS.values()),
                "fused_graphs": len(fused.GRAPHS)}

    # ------------------------------------------------------------ the check
    def statement(self, s: int, b: int, tampered: bool = False):
        """The reference's statement of deck b of set s, from the seed's
        points, permutation and remask factors."""
        p = self.params
        pool = self.pool
        idx = self.card_idx[s, b]
        deck_in = [tuple(ec.add(pool[idx[j, c, 0]], pool[idx[j, c, 1]]) for c in (0, 1)) for j in range(self.N)]
        rho = [inputs.limbs_int(r) for r in self.rho[s, b]]
        deck_out = ref.remask(deck_in, self.pi[s, b].tolist(), rho, self._fixed("gen"), self._fixed("pk"))
        if tampered:
            deck_out[0] = deck_in[0]
        return ref.statement(p["gen"], p["pk"], p["ck_g"], p["ck_h"], p["sgen"], self.m, deck_in, deck_out)

    def _fixed(self, name: str) -> ec.FixedBase:
        if name not in self.fixed_bases:
            self.fixed_bases[name] = ec.FixedBase(self.params[name])
        return self.fixed_bases[name]

    def checks(self) -> dict:
        """Each number compared, with its limit."""
        draws = Draws(self.seed, "check")
        pairs = [(k, j) for k, (_, _, lanes, _) in enumerate(self.kept) for j in range(len(lanes))]
        picked = draws.pick(pairs, self.traffic["reference_proofs"])
        ref_rejected = 0
        for k, j in picked:
            _, s, lanes, proofs = self.kept[k]
            proof = read_proof(tree_map(lambda t: t[j], proofs))
            ref_rejected += ref.verify(self.statement(s, int(lanes[j])), proof) is not None

        # the port's verifier on a tampered statement: the last call's proofs
        s, proof = self.last
        deck_in, deck_out, _, _ = self.statements[s]
        tamper = np.zeros(self.B, bool)
        tamper[draws.np.permutation(self.B)[: max(1, self.B // 2)]] = True
        sel = torch.as_tensor(tamper, device=self.device)
        bad_out = Ciphertexts(*(_replace_card0(o, i, sel) for o, i in zip(deck_out, deck_in)))
        checks = device_api.verify_shuffle(self.cv, self.m, self.n, self.keys, deck_in, bad_out, proof)
        ok = (checks.hadamard & checks.svp & checks.multi_exp).cpu().numpy()
        tamper_missed = int(np.sum(ok == tamper))
        b0 = int(np.flatnonzero(tamper)[0])
        ref_tamper_accepted = int(ref.verify(self.statement(s, b0, tampered=True),
                                             read_proof(tree_map(lambda t: t[b0], proof))) is None)
        return {
            "port_rejected": (int(self.rejected), 0),
            "ref_rejected": (ref_rejected, 0),
            "tamper_missed": (tamper_missed, 0),
            "ref_tamper_accepted": (ref_tamper_accepted, 0),
        }

    def failed(self) -> int:
        return int(self.rejected)


def _replace_card0(out_pt, in_pt, sel):
    """Card 0 of the output deck replaced by card 0 of the input deck in
    the decks `sel` marks."""
    def one(o, i):
        o = o.clone()
        o[:, 0] = torch.where(sel[:, None], i[:, 0], o[:, 0])
        return o
    return type(out_pt)(*(one(o, i) for o, i in zip(out_pt, in_pt)))


def read_proof(p):
    """One deck's device proof (no batch axis) as the reference's tree of
    integers and affine points."""
    from types import SimpleNamespace as NS

    pts = inputs.affine_list
    one = lambda a: inputs.affine_list(a)[0]
    sc = lambda t: inputs.scalar_list(t)[0]
    vec = inputs.scalar_list
    z, had, svp, me = p.product.hadamard.zero, p.product.hadamard, p.product.svp, p.multi_exp
    return NS(
        c_a=pts(p.c_a), c_b=pts(p.c_b),
        product=NS(
            c_b=one(p.product.c_b),
            hadamard=NS(c_B_mid=pts(had.c_B_mid),
                        zero=NS(c_a0=one(z.c_a0), c_bm1=one(z.c_bm1), c_d=pts(z.c_d), a=vec(z.a), r=sc(z.r),
                                b=vec(z.b), s=sc(z.s), t=sc(z.t))),
            svp=NS(c_d=one(svp.c_d), c_delta=one(svp.c_delta), c_Delta=one(svp.c_Delta), a_tilde=vec(svp.a_tilde),
                   r_tilde=sc(svp.r_tilde), b_tilde=vec(svp.b_tilde), s_tilde=sc(svp.s_tilde))),
        multi_exp=NS(c_a0=one(me.c_a0), c_b=pts(me.c_b), e0=pts(me.e0), e1=pts(me.e1), a=vec(me.a), r=sc(me.r),
                     b=sc(me.b), s=sc(me.s), tau=sc(me.tau)),
    )
