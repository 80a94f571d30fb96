"""Host Fiat-Shamir transcripts: the protocol seeds, ChaCha20, FiatShamirRng
and TranscriptBatch.

A copy of `mental_poker_tpu/crypto/transcript.py` (host code): the five
domain-separation seeds, the ChaCha20 word stream that backs the seeded
`GameRng`, `FiatShamirRng`, and the `TranscriptBatch` of B independent
transcripts that the sigma protocols and the host Bayer-Groth provers use.
Semantics are ark-marlin 0.3 `FiatShamirRng<Blake2s>`:

- ``from_seed(bytes)``: ``seed = Blake2s(bytes)``; ChaCha20 keyed with it.
- ``absorb(bytes)``: ``seed = Blake2s(bytes || seed)``; ChaCha20 re-keyed.
- field sampling: arkworks 0.3 ``UniformRand`` for ``Fp`` (64-bit words,
  top word masked, rejection until < modulus, read as Montgomery repr).
"""

from __future__ import annotations

import hashlib
import struct

# Protocol domain-separation seeds (reference `mod.rs:80-84`).
KEY_OWN_RNG_SEED = b"Key Ownership Proof"
MASKING_RNG_SEED = b"Masking Proof"
REMASKING_RNG_SEED = b"Remasking Proof"
REVEAL_RNG_SEED = b"Reveal Proof"
SHUFFLE_RNG_SEED = b"Shuffle Proof"


def _rotl32(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & 0xFFFFFFFF


class ChaCha20Words:
    """ChaCha20 keystream as u32 words (rand_chacha semantics): 32-byte key,
    64-bit block counter from 0, nonce 0."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20 key must be 32 bytes")
        self.key_words = struct.unpack("<8I", key)
        self.counter = 0
        self._buf: list[int] = []

    def _block(self) -> list[int]:
        c = self.counter
        state = [
            0x61707865, 0x3320646E, 0x79622D32, 0x6B206574,
            *self.key_words,
            c & 0xFFFFFFFF, (c >> 32) & 0xFFFFFFFF, 0, 0,
        ]
        x = list(state)

        def qr(a, b, c_, d):
            x[a] = (x[a] + x[b]) & 0xFFFFFFFF
            x[d] = _rotl32(x[d] ^ x[a], 16)
            x[c_] = (x[c_] + x[d]) & 0xFFFFFFFF
            x[b] = _rotl32(x[b] ^ x[c_], 12)
            x[a] = (x[a] + x[b]) & 0xFFFFFFFF
            x[d] = _rotl32(x[d] ^ x[a], 8)
            x[c_] = (x[c_] + x[d]) & 0xFFFFFFFF
            x[b] = _rotl32(x[b] ^ x[c_], 7)

        for _ in range(10):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        out = [(a + b) & 0xFFFFFFFF for a, b in zip(x, state)]
        self.counter += 1
        return out

    def next_u32(self) -> int:
        if not self._buf:
            self._buf = self._block()
        return self._buf.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return lo | (hi << 32)

    def keystream(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            out += struct.pack("<I", self.next_u32())
        return bytes(out[:n])


class FiatShamirRng:
    """ark-marlin 0.3 `FiatShamirRng<Blake2s>` on the host."""

    def __init__(self, seed_bytes: bytes):
        self.seed = hashlib.blake2s(seed_bytes).digest()
        self.rng = ChaCha20Words(self.seed)

    def absorb(self, data: bytes) -> None:
        self.seed = hashlib.blake2s(bytes(data) + self.seed).digest()
        self.rng = ChaCha20Words(self.seed)

    def sample_field(self, modulus: int) -> int:
        """Canonical value whose Montgomery repr (R = 2^(64*words)) is the
        accepted uniform bigint."""
        bits = modulus.bit_length()
        words = -(-bits // 64)
        top_mask = (1 << 64) - 1 >> (64 * words - bits)
        r_inv = pow(1 << (64 * words), -1, modulus)
        while True:
            ws = [self.rng.next_u64() for _ in range(words)]
            ws[-1] &= top_mask
            val = sum(w << (64 * i) for i, w in enumerate(ws))
            if val < modulus:
                return val * r_inv % modulus


class TranscriptBatch:
    """A batch of B independent Fiat-Shamir transcripts (one per proof)."""

    def __init__(self, seeds: list[bytes]):
        self.ts = [FiatShamirRng(s) for s in seeds]

    @classmethod
    def fixed(cls, seed: bytes, batch: int) -> "TranscriptBatch":
        return cls([seed] * batch)

    def __len__(self):
        return len(self.ts)

    def absorb(self, blobs: list[bytes]) -> None:
        if len(blobs) != len(self.ts):
            raise ValueError(f"{len(blobs)} blobs for {len(self.ts)} transcripts")
        for t, b in zip(self.ts, blobs):
            t.absorb(b)

    def sample_field(self, modulus: int) -> list[int]:
        return [t.sample_field(modulus) for t in self.ts]
