"""Fiat-Shamir transcripts in plain Python: ark-marlin 0.3
`FiatShamirRng<Blake2s>` over a ChaCha20 keystream.

- from_seed(bytes): seed = Blake2s(bytes), ChaCha20 keyed with it;
- absorb(bytes): seed = Blake2s(bytes || seed), ChaCha20 re-keyed;
- a field draw: arkworks 0.3 `UniformRand` for Fp (64-bit words, the top
  word masked, rejected until below the modulus, read as a Montgomery
  representation with R = 2^(64 words)).
"""

from __future__ import annotations

import hashlib
import struct

MASKING = b"Masking Proof"
REMASKING = b"Remasking Proof"
REVEAL = b"Reveal Proof"
SHUFFLE = b"Shuffle Proof"

_M32 = 0xFFFFFFFF


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & _M32


def chacha20_block(key_words, counter: int) -> list:
    """One ChaCha20 block (RFC 8439 rounds, 64-bit counter, nonce 0) as
    16 little-endian u32 words."""
    state = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574, *key_words,
             counter & _M32, (counter >> 32) & _M32, 0, 0]
    x = list(state)

    def qr(a, b, c, d):
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl(x[d] ^ x[a], 16)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl(x[b] ^ x[c], 12)
        x[a] = (x[a] + x[b]) & _M32
        x[d] = _rotl(x[d] ^ x[a], 8)
        x[c] = (x[c] + x[d]) & _M32
        x[b] = _rotl(x[b] ^ x[c], 7)

    for _ in range(10):
        qr(0, 4, 8, 12)
        qr(1, 5, 9, 13)
        qr(2, 6, 10, 14)
        qr(3, 7, 11, 15)
        qr(0, 5, 10, 15)
        qr(1, 6, 11, 12)
        qr(2, 7, 8, 13)
        qr(3, 4, 9, 14)
    return [(a + b) & _M32 for a, b in zip(x, state)]


class Transcript:
    def __init__(self, seed_bytes: bytes):
        self._rekey(hashlib.blake2s(seed_bytes).digest())

    def _rekey(self, seed: bytes) -> None:
        self.seed = seed
        self.key_words = struct.unpack("<8I", seed)
        self.counter = 0
        self.buf = []

    def absorb(self, data: bytes) -> None:
        self._rekey(hashlib.blake2s(bytes(data) + self.seed).digest())

    def _u32(self) -> int:
        if not self.buf:
            self.buf = chacha20_block(self.key_words, self.counter)
            self.counter += 1
        return self.buf.pop(0)

    def _u64(self) -> int:
        lo = self._u32()
        return lo | (self._u32() << 32)

    def challenge(self, modulus: int) -> int:
        bits = modulus.bit_length()
        words = -(-bits // 64)
        top_mask = ((1 << 64) - 1) >> (64 * words - bits)
        r_inv = pow(1 << (64 * words), -1, modulus)
        while True:
            ws = [self._u64() for _ in range(words)]
            ws[-1] &= top_mask
            val = sum(w << (64 * i) for i, w in enumerate(ws))
            if val < modulus:
                return val * r_inv % modulus
