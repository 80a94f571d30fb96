"""One card of one game of the card protocol, worked out in Python integers:
the plain reference for the game cell.

For a card of game g with generator G, player keys sk_p and the card's
draws (alpha, k, beta, k2, k3_p):

- keys: pk_p = sk_p G, the aggregate key pk = sum_p pk_p;
- mask: c0 = alpha G, c1 = card + alpha pk, with a Chaum-Pedersen proof
  (seed "Masking Proof") that c0 and c1 - card share alpha over (G, pk);
- remask: r0 = beta G, r1 = beta pk, d = c + r, with a proof (seed
  "Remasking Proof") over (G, pk) for (r0, r1);
- reveal: token_p = sk_p d0, with a proof (seed "Reveal Proof") over
  (d0, G) for (token_p, pk_p);
- unmask: d1 - sum_p token_p gives the card back.

`mismatches` compares a lane the program produced with this and names
every value that differs; every verdict the program gave must be true.
"""

from __future__ import annotations

from . import curve as ec
from . import sigma
from .transcript import MASKING, REMASKING, REVEAL


def expected(lane) -> dict:
    G = lane["gen"]
    pks = [ec.mul(sk, G) for sk in lane["sks"]]
    pk = ec.to_affine(ec.msm_jac(pks, [1] * len(pks)))
    card = lane["card"]
    alpha, beta = lane["alpha"], lane["beta"]
    c0 = ec.mul(alpha, G)
    c1 = ec.add(card, ec.mul(alpha, pk))
    mask = sigma.prove(MASKING, G, pk, c0, ec.add(c1, ec.neg(card)), alpha, lane["k"])
    r0, r1 = ec.mul(beta, G), ec.mul(beta, pk)
    d0, d1 = ec.add(c0, r0), ec.add(c1, r1)
    remask = sigma.prove(REMASKING, G, pk, r0, r1, beta, lane["k2"])
    tokens = [ec.mul(sk, d0) for sk in lane["sks"]]
    reveal = [sigma.prove(REVEAL, d0, G, t, pk_p, sk, k3)
              for t, pk_p, sk, k3 in zip(tokens, pks, lane["sks"], lane["k3"])]
    plain = ec.add(d1, ec.neg(ec.to_affine(ec.msm_jac(tokens, [1] * len(tokens)))))
    return dict(c0=c0, c1=c1, d0=d0, d1=d1, tokens=tokens, mask_proof=mask, remask_proof=remask,
                reveal_proofs=reveal, plain=plain)


def mismatches(lane) -> list:
    """Names of the lane's values that differ from the reference, and of
    its verdicts that are false."""
    want = expected(lane)
    bad = [k for k in ("c0", "c1", "d0", "d1", "tokens", "mask_proof", "remask_proof", "reveal_proofs", "plain")
           if lane[k] != want[k]]
    if want["plain"] != lane["card"]:
        bad.append("reference_unmask")
    bad += [f"verdict_{name}" for name, ok in lane["verdicts"].items() if not ok]
    return bad
