"""Chaum-Pedersen discrete-log equality in Python integers: the plain
reference for the game cell's mask, remask and reveal proofs.

Transcript: absorb(bytes(g) || bytes(h) || bytes(a) || bytes(b) ||
bytes(t_g) || bytes(t_h)) on a transcript seeded with the step's domain
seed; c is one field draw; s = k + c w mod q. The game cell's check makes
each proof again from the kept nonce and compares it whole.
"""

from __future__ import annotations

from . import curve as ec
from .transcript import Transcript


def challenge(seed: bytes, g, h, a, b, t_g, t_h) -> int:
    ts = Transcript(seed)
    ts.absorb(b"".join(ec.point_bytes(p) for p in (g, h, a, b, t_g, t_h)))
    return ts.challenge(ec.Q)


def prove(seed: bytes, g, h, a, b, w: int, k: int):
    """-> (t_g, t_h, s) for a = w g, b = w h with the nonce k."""
    t_g, t_h = ec.mul(k, g), ec.mul(k, h)
    c = challenge(seed, g, h, a, b, t_g, t_h)
    return t_g, t_h, (k + c * w) % ec.Q
