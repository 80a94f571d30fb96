"""The Bayer-Groth shuffle verifier in Python integers: the plain reference
that judges every sampled proof of the shuffle cells.

A statement is the public parameters (ElGamal generator, aggregate key,
the n Pedersen generators and the blinding generator, the shuffle
generator G'), the deck split (m, n) and the input and output decks as
affine (c0, c1) pairs. A proof is a `SimpleNamespace` tree with the
fields of the Bayer-Groth argument (shuffle, product, Hadamard, zero,
single-value product, multi-exponentiation). `verify` follows the
argument's absorb schedule and returns the name of the first failed
sub-argument, or None when the proof is sound for the statement.
"""

from __future__ import annotations

import hashlib
from types import SimpleNamespace

from . import curve as ec
from .transcript import SHUFFLE, Transcript

Q = ec.Q
HADAMARD = "Hadamard Product (5.1)"
ZERO = "Zero Argument (5.2)"
SVP = "Single Value Product Argument (5.3)"
MULTI_EXP = "Multi-exponentiation Argument (4.1)"


def points_bytes(pts) -> bytes:
    return b"".join(ec.point_bytes(p) for p in pts)


def cipher_bytes(pairs) -> bytes:
    return b"".join(ec.point_bytes(a) + ec.point_bytes(b) for a, b in pairs)


def deck_root(deck) -> bytes:
    """Binary Blake2s Merkle root over the cards' (c0 || c1) bytes; an odd
    node is promoted as it is."""
    level = [hashlib.blake2s(cipher_bytes([c])).digest() for c in deck]
    while len(level) > 1:
        nxt = [hashlib.blake2s(level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)]
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


def remask(deck, pi, rho, gen: ec.FixedBase, pk: ec.FixedBase):
    """out[i] = deck[pi[i]] + E(0; rho[i]) = (c0 + rho G, c1 + rho pk)."""
    out = []
    for i, r in zip(pi, rho):
        c0, c1 = deck[i]
        out.append((ec.to_affine(ec.jadd(ec.to_jac(c0), gen.mul_jac(r))),
                    ec.to_affine(ec.jadd(ec.to_jac(c1), pk.mul_jac(r)))))
    return out


class Verifier:
    def __init__(self, st):
        self.st = st
        self.n = len(st.ck_g)

    def com(self, vec, r):
        vec = list(vec)
        return ec.msm(list(self.st.ck_g[: len(vec)]) + [self.st.ck_h], vec + [r])

    def verify(self, proof):
        st, n, m = self.st, self.n, self.st.m
        N = m * n
        ts = Transcript(SHUFFLE)
        ts.absorb(ec.point_bytes(st.pk) + deck_root(st.deck_in) + deck_root(st.deck_out)
                  + m.to_bytes(8, "little") + n.to_bytes(8, "little"))
        ts.absorb(points_bytes(proof.c_a))
        x = ts.challenge(Q)
        ts.absorb(points_bytes(proof.c_b))
        y = ts.challenge(Q)
        z = ts.challenge(Q)

        c_mz = self.com([(-z) % Q] * n, 0)
        c_d = [ec.add(ec.msm([proof.c_a[k], proof.c_b[k]], [y, 1]), c_mz) for k in range(m)]
        v = 1
        for i in range(1, N + 1):
            v = v * ((y * i + pow(x, i, Q) - z) % Q) % Q

        bad = self.product(ts, proof.product, c_d, v)
        if bad:
            return bad
        xpow = [pow(x, i, Q) for i in range(1, N + 1)]
        T = (ec.msm([c[0] for c in st.deck_in], xpow), ec.msm([c[1] for c in st.deck_in], xpow))
        return self.multi_exp(ts, proof.multi_exp, st.deck_out, T, proof.c_b)

    def product(self, ts, pr, c_a, v):
        ts.absorb(points_bytes([pr.c_b]))
        if self.hadamard(ts, pr.hadamard, c_a, pr.c_b):
            return HADAMARD
        return self.svp(ts, pr.svp, pr.c_b, v)

    def hadamard(self, ts, hp, c_a, c_b):
        m, n = len(c_a), self.n
        ts.absorb(points_bytes(hp.c_B_mid) if hp.c_B_mid else b"hadamard:no-mid")
        x = ts.challenge(Q)
        y = ts.challenge(Q)
        xi = [pow(x, i, Q) for i in range(m + 1)]
        c_B = [c_a[0]] + list(hp.c_B_mid) + [c_b]
        c_D = [ec.msm([c_B[i - 1]], [xi[i]]) for i in range(1, m)]
        c_Dsum = ec.msm(c_B[1:], [xi[i] for i in range(1, m)])
        c_minus1 = self.com([Q - 1] * n, 0)
        return self.zero(ts, hp.zero, c_D + [c_Dsum], list(c_a[1:]) + [c_minus1], y)

    def zero(self, ts, zp, c_a, c_b, y):
        m = len(c_a)
        ts.absorb(points_bytes([zp.c_a0, zp.c_bm1] + list(zp.c_d)))
        x = ts.challenge(Q)
        xi = [pow(x, i, Q) for i in range(2 * m + 2)]
        bil, yp = 0, y
        for aj, bj in zip(zp.a, zp.b):
            bil = (bil + aj * bj % Q * yp) % Q
            yp = yp * y % Q
        ok = (
            self.com(zp.a, zp.r) == ec.msm([zp.c_a0] + list(c_a), xi[: m + 1])
            and self.com(zp.b, zp.s) == ec.msm(list(c_b) + [zp.c_bm1], [xi[m + 1 - j] for j in range(1, m + 2)])
            and self.com([bil], zp.t) == ec.msm(list(zp.c_d), xi[: 2 * m + 1])
            and zp.c_d[m + 1] == ec.IDENTITY
        )
        return None if ok else ZERO

    def svp(self, ts, sp, c_a, v):
        n = len(sp.a_tilde)
        ts.absorb(points_bytes([sp.c_d, sp.c_delta, sp.c_Delta]))
        x = ts.challenge(Q)
        e = [(x * sp.b_tilde[j] - sp.b_tilde[j - 1] * sp.a_tilde[j]) % Q for j in range(1, n)]
        ok = (
            self.com(sp.a_tilde, sp.r_tilde) == ec.msm([c_a, sp.c_d], [x, 1])
            and self.com(e, sp.s_tilde) == ec.msm([sp.c_Delta, sp.c_delta], [x, 1])
            and sp.b_tilde[0] == sp.a_tilde[0]
            and sp.b_tilde[-1] == x * v % Q
        )
        return None if ok else SVP

    def multi_exp(self, ts, mp, deck_out, T, c_a):
        st, n = self.st, self.n
        m = len(c_a)
        e = list(zip(mp.e0, mp.e1))
        ts.absorb(points_bytes([mp.c_a0] + list(mp.c_b)) + cipher_bytes(e))
        x = ts.challenge(Q)
        xj = [pow(x, j, Q) for j in range(2 * m)]
        ok = e[m] == tuple(T) and mp.c_b[m] == ec.IDENTITY
        ok = ok and self.com(mp.a, mp.r) == ec.msm([mp.c_a0] + list(c_a), [1] + [pow(x, j, Q) for j in range(1, m + 1)])
        ok = ok and self.com([mp.b], mp.s) == ec.msm(list(mp.c_b), xj)
        if ok:
            lhs = (ec.msm([p[0] for p in e], xj), ec.msm([p[1] for p in e], xj))
            scal = []
            for i in range(1, m + 1):
                w = pow(x, m - i, Q)
                scal.extend(w * aj % Q for aj in mp.a)
            rows = deck_out[: m * n]
            r0 = ec.msm_jac([c[0] for c in rows] + [st.gen], scal + [mp.tau])
            r1 = ec.msm_jac([c[1] for c in rows] + [st.sgen, st.pk], scal + [mp.b, mp.tau])
            ok = lhs == (ec.to_affine(r0), ec.to_affine(r1))
        return None if ok else MULTI_EXP


def statement(gen, pk, ck_g, ck_h, sgen, m, deck_in, deck_out) -> SimpleNamespace:
    return SimpleNamespace(gen=gen, pk=pk, ck_g=list(ck_g), ck_h=ck_h, sgen=sgen, m=m,
                           deck_in=list(deck_in), deck_out=list(deck_out))


def verify(st, proof):
    """The first failed sub-argument's name, or None."""
    return Verifier(st).verify(proof)
