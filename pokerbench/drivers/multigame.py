"""Traffic of the game cells: a closed loop of rounds of G games of P
players, the card protocol on the device (the multigame flow).

Set-up (from the seed): G generators, the (G, P) secret keys and G N cards
(each the sum of two pool points), all drawn on the host; on the device
the player keys sk G (`Curve.scalar_mul`) and each game's aggregate key,
the sum of its players' keys. The runtime config fixes `msm_nc` and the
fixed-base window.

A call is one round of every game: fresh nonces and blinding factors from
a seeded device generator; every card masked (alpha G, card + alpha pk),
remasked, and revealed by every player (sk_p d0), each step with a
Chaum-Pedersen proof that is verified (`crypto/sigma_device.py`); then
unmasked, d1 - sum_p token_p, and compared with the card. The call counts
the false verdicts on the device and keeps a few cards' inputs and outputs,
drawn from the seed; then it synchronises.

After the window the reference (Python integers) works out a sample of
the kept cards again, down to each proof, and the port's verifier is given
the last round's reveal proofs with half of the responses altered, which it
must reject exactly there.
"""

from __future__ import annotations

import numpy as np
import torch

from mental_poker_tpu_torch import config as pconfig
from mental_poker_tpu_torch.arguments.device import tree_map
from mental_poker_tpu_torch.crypto import sigma_device as sdev
from mental_poker_tpu_torch.crypto import transcript_dev as dt
from mental_poker_tpu_torch.crypto.transcript import MASKING_RNG_SEED, REMASKING_RNG_SEED, REVEAL_RNG_SEED
from mental_poker_tpu_torch.ops.curve import PointP, map_point, stark_curve

from .. import inputs
from ..inputs import Draws
from ..reference import curve as ec
from ..reference import game as ref

CURVES = {"stark": stark_curve}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _repeat(P: PointP, reps: int) -> PointP:
    return map_point(lambda t: t.repeat_interleave(reps, dim=0), P)


def _take(tree, idx):
    return tree_map(lambda t: t[idx], tree)


class Driver:
    unit = "games"

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.device = dev = torch.device(device)
        G = self.G = traffic["games"]
        P = self.P = conf["players"]
        N = self.N = conf["m"] * conf["n"]
        self.GN, self.M = G * N, G * P * N
        self.traffic = traffic
        self.seed = seed
        pconfig.set_config(pconfig.RuntimeConfig(msm_nc=conf["msm_nc"], fixed_window_bits=conf["fixed_window_bits"]))
        cv = self.cv = CURVES[conf["curve"]]()
        L = cv.fr.L

        draws = Draws(seed, "game")
        self.gens_host = draws.points(G)
        self.pool = draws.points(traffic["pool"])
        self.sks = draws.scalars((G, P))
        self.card_idx = draws.indices((self.GN, 2), len(self.pool))

        gens = cv.from_host_points(self.gens_host, dev)
        self.sks_d = torch.as_tensor(self.sks, device=dev)
        pks = cv.scalar_mul(self.sks_d, map_point(lambda t: t[:, None].expand(G, P, t.shape[-1]), gens))
        agg = cv.sum_points(pks, axis=1)
        pool = cv.from_host_points(self.pool, dev)
        idx = torch.as_tensor(self.card_idx, device=dev)
        self.cards = cv.add(_take(pool, idx[:, 0]), _take(pool, idx[:, 1]))
        self.g_b = _repeat(gens, N)  # [G N] each game's generator, once a card
        self.pk_b = _repeat(agg, N)  # [G N] each game's aggregate key
        self.g_bb = _repeat(gens, P * N)  # [G P N]
        self.pk_pl = map_point(lambda t: t.repeat_interleave(N, dim=1).reshape(self.M, -1), pks)
        self.sk_b = self.sks_d[:, :, None, :].expand(G, P, N, L).reshape(self.M, L)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(seed % 2**63)
        self.lane_draws = Draws(seed, "lanes")
        self.bad = torch.zeros((), dtype=torch.int64, device=dev)  # false verdicts
        self.failed_games = torch.zeros((), dtype=torch.int64, device=dev)  # games with one or more
        self.kept = []
        self.last = None
        _sync(dev)

    def draw(self, count: int) -> torch.Tensor:
        k = torch.randint(0, 1 << 16, (count, inputs.L), generator=self.gen, device=self.device, dtype=torch.int32)
        k[:, inputs.L - 1] &= inputs.TOP_MASK
        return k

    # ------------------------------------------------------------ the calls
    def flow(self) -> dict:
        """One round of every game; every input and output by name."""
        cv, G, P, N, GN, M = self.cv, self.G, self.P, self.N, self.GN, self.M
        dev = self.device
        # mask every card, prove and verify
        alpha = self.draw(GN)
        c0 = cv.scalar_mul(alpha, self.g_b)
        c1 = cv.add(self.cards, cv.scalar_mul(alpha, self.pk_b))
        stmt_b = cv.add(c1, cv.neg(self.cards))
        k = self.draw(GN)
        mask = sdev.cp_prove_dev(cv, dt.init(MASKING_RNG_SEED, (GN,), dev), self.g_b, self.pk_b, c0, stmt_b, alpha, k)
        ok_mask = sdev.cp_verify_dev(cv, dt.init(MASKING_RNG_SEED, (GN,), dev), self.g_b, self.pk_b, c0, stmt_b, mask)
        # remask, prove and verify
        beta = self.draw(GN)
        r0 = cv.scalar_mul(beta, self.g_b)
        r1 = cv.scalar_mul(beta, self.pk_b)
        d0, d1 = cv.add(c0, r0), cv.add(c1, r1)
        k2 = self.draw(GN)
        remask = sdev.cp_prove_dev(cv, dt.init(REMASKING_RNG_SEED, (GN,), dev), self.g_b, self.pk_b, r0, r1, beta, k2)
        ok_remask = sdev.cp_verify_dev(cv, dt.init(REMASKING_RNG_SEED, (GN,), dev), self.g_b, self.pk_b, r0, r1, remask)
        # every player's reveal token for every card, prove and verify
        d0_b = map_point(lambda t: t.reshape(G, 1, N, -1).expand(G, P, N, t.shape[-1]).reshape(M, -1), d0)
        tokens = cv.scalar_mul(self.sk_b, d0_b)
        k3 = self.draw(M)
        reveal = sdev.cp_prove_dev(cv, dt.init(REVEAL_RNG_SEED, (M,), dev), d0_b, self.g_bb, tokens, self.pk_pl, self.sk_b, k3)
        ok_reveal = sdev.cp_verify_dev(cv, dt.init(REVEAL_RNG_SEED, (M,), dev), d0_b, self.g_bb, tokens, self.pk_pl, reveal)
        # unmask: d1 - sum_p token_p
        tok_sum = cv.sum_points(map_point(lambda t: t.reshape(G, P, N, -1), tokens), axis=1)
        plain = cv.add(cv.neg(map_point(lambda t: t.reshape(GN, -1), tok_sum)), d1)
        ok_plain = cv.eq(plain, self.cards)
        return dict(alpha=alpha, k=k, beta=beta, k2=k2, k3=k3, c0=c0, c1=c1, d0=d0, d1=d1, d0_b=d0_b,
                    tokens=tokens, mask=mask, remask=remask, reveal=reveal, plain=plain,
                    ok_mask=ok_mask, ok_remask=ok_remask, ok_reveal=ok_reveal, ok_plain=ok_plain)

    def warm(self) -> None:
        self.flow()
        _sync(self.device)

    def call(self, i: int) -> int:
        out = self.flow()
        G, P, N = self.G, self.P, self.N
        ok = (out["ok_mask"].reshape(G, N), out["ok_remask"].reshape(G, N), out["ok_plain"].reshape(G, N),
              out["ok_reveal"].reshape(G, P * N))
        self.bad += sum((~o).sum() for o in ok)
        self.failed_games += (~torch.stack([o.all(1) for o in ok]).all(0)).sum()
        lanes = self.lane_draws.choose(self.GN, self.traffic["kept_per_call"])
        card = torch.as_tensor(lanes, device=self.device)
        g, j = card // self.N, card % self.N
        rev = ((g[:, None] * self.P + torch.arange(self.P, device=self.device)) * self.N + j[:, None]).reshape(-1)
        keep = {name: _take(out[name], card) for name in ("alpha", "k", "beta", "k2", "c0", "c1", "d0", "d1", "mask", "remask", "plain",
                             "ok_mask", "ok_remask", "ok_plain")}
        keep.update({name: _take(out[name], rev) for name in ("k3", "tokens", "reveal", "ok_reveal")})
        self.kept.append((lanes, keep))
        self.last = out
        _sync(self.device)
        return self.G

    def trace_call(self) -> None:
        self.flow()

    def counters(self) -> dict:
        return {}

    # ------------------------------------------------------------ the check
    def lane(self, card: int, keep: dict, r: int) -> dict:
        """The r-th kept card of a call as the reference's integers."""
        P = self.P
        g = card // self.N
        pr = lambda key: inputs.projective_list(_take(keep[key], slice(r, r + 1)))[0]
        sc = lambda key, rows: inputs.scalar_list(keep[key][rows])

        def proofs(key, rows):
            p = keep[key]
            return list(zip(inputs.affine_list(_take(p.t_g, rows)), inputs.affine_list(_take(p.t_h, rows)),
                            inputs.scalar_list(p.s[rows])))

        one, many = slice(r, r + 1), slice(r * P, (r + 1) * P)
        a, b = self.pool[self.card_idx[card, 0]], self.pool[self.card_idx[card, 1]]
        return dict(
            gen=self.gens_host[g], sks=[inputs.limbs_int(s) for s in self.sks[g]], card=ec.add(a, b),
            alpha=sc("alpha", one)[0], k=sc("k", one)[0], beta=sc("beta", one)[0], k2=sc("k2", one)[0],
            k3=sc("k3", many),
            c0=pr("c0"), c1=pr("c1"), d0=pr("d0"), d1=pr("d1"), plain=pr("plain"),
            tokens=inputs.projective_list(_take(keep["tokens"], many)),
            mask_proof=proofs("mask", one)[0], remask_proof=proofs("remask", one)[0],
            reveal_proofs=proofs("reveal", many),
            verdicts=dict(mask=bool(keep["ok_mask"][r]), remask=bool(keep["ok_remask"][r]),
                          reveal=bool(keep["ok_reveal"][many].all()), unmask=bool(keep["ok_plain"][r])),
        )

    def checks(self) -> dict:
        draws = Draws(self.seed, "check")
        pairs = [(c, r) for c, (lanes, _) in enumerate(self.kept) for r in range(len(lanes))]
        picked = draws.pick(pairs, self.traffic["reference_cards"])
        mismatched = 0
        for c, r in picked:
            lanes, keep = self.kept[c]
            mismatched += bool(ref.mismatches(self.lane(int(lanes[r]), keep, r)))

        # the port's verifier on the last round's reveal proofs, half of them altered
        out = self.last
        tamper = np.zeros(self.M, bool)
        tamper[draws.np.permutation(self.M)[: max(1, self.M // 2)]] = True
        t_d = torch.as_tensor(tamper, device=self.device)
        s = out["reveal"].s.clone()
        s[:, 0] = torch.where(t_d, s[:, 0] ^ 1, s[:, 0])
        bad = out["reveal"]._replace(s=s)
        ok = sdev.cp_verify_dev(self.cv, dt.init(REVEAL_RNG_SEED, (self.M,), self.device), out["d0_b"], self.g_bb,
                                out["tokens"], self.pk_pl, bad)
        tamper_missed = int((ok == t_d).sum())
        return {
            "port_rejected": (int(self.bad), 0),
            "ref_mismatched": (mismatched, 0),
            "tamper_missed": (tamper_missed, 0),
        }

    def failed(self) -> int:
        return int(self.failed_games)
