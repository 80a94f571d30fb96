"""Blake2s and ChaCha20 as batched PyTorch integer ops.

Counterpart of `mental_poker_tpu/crypto/hash_jax.py`: the Fiat-Shamir
transcript (`crypto/transcript_dev.py`) and the deck Merkle root run on the
device, batched over independent transcripts. 32-bit words are held in int64
tensors with values in [0, 2^32); every addition and rotation masks with
0xFFFFFFFF explicitly (PyTorch has no unsigned 32-bit arithmetic on the
CPU). These PyTorch versions are the plain reference and run on CPU
tensors; on CUDA tensors `blake2s` / `blake2s_bytes` launch the kernel of
`ops/cuda/hash.py`, as the transcript's draw launches its ChaCha20 kernel
(`chacha20_block` / `chacha20_words` are the plain draw's stream). Rounds
use the 4-lane formulation: a column step is elementwise over [..., 4]
rows, a diagonal step rotates the rows first.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.cuda import hash as cuda_hash

M32 = 0xFFFFFFFF

_BLAKE2S_IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

_SIGMA = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
        [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
        [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
        [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
        [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
        [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
        [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
        [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
        [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    ]
)

# Message-word indices per round and step (col-a, col-b, diag-a, diag-b),
# 4 lanes each: [10, 4, 4].
_MSG_IDX = np.stack(
    [
        np.stack([_SIGMA[r, 0:8:2], _SIGMA[r, 1:8:2], _SIGMA[r, 8:16:2], _SIGMA[r, 9:16:2]])
        for r in range(10)
    ]
)

_CHACHA_CONST = [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574]


def _rotr(v, n: int):
    return ((v >> n) | (v << (32 - n))) & M32


def _rotl(v, n: int):
    return ((v << n) | (v >> (32 - n))) & M32


def _g(a, b, c, d, mx, my):
    """Four parallel Blake2s G functions over [..., 4] rows."""
    a = (a + b + mx) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + my) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


@functools.cache
def _consts(device: torch.device, t: int, last: bool):
    """Cached per device: the IV, the counter/flag row d for (t, last), and
    the message schedule as one flat index (round r, step j at 16r + 4j)."""
    iv = torch.tensor(_BLAKE2S_IV, dtype=torch.int64, device=device)
    d = torch.tensor(
        [
            _BLAKE2S_IV[4] ^ (t & M32),
            _BLAKE2S_IV[5] ^ ((t >> 32) & M32),
            _BLAKE2S_IV[6] ^ (M32 if last else 0),
            _BLAKE2S_IV[7],
        ],
        dtype=torch.int64,
        device=device,
    )
    return iv, d, torch.as_tensor(_MSG_IDX.reshape(-1), device=device)


@functools.cache
def _blake2s_h0(device: torch.device) -> torch.Tensor:
    """The initial state of an unkeyed 32-byte digest, cached per device."""
    h0 = list(_BLAKE2S_IV)
    h0[0] ^= 0x01010020  # digest length 32, fanout = depth = 1
    return torch.tensor(h0, dtype=torch.int64, device=device)


@functools.cache
def _chacha_const(device: torch.device) -> torch.Tensor:
    return torch.tensor(_CHACHA_CONST, dtype=torch.int64, device=device)


def _compress(h, m, t: int, last: bool):
    """One Blake2s compression: h [..., 8], m [..., 16]; t, last static."""
    iv, d_row, sched = _consts(h.device, t, last)
    ms = m[..., sched]  # [..., 160]: every round's message words, in order
    a, b = h[..., 0:4], h[..., 4:8]
    c = iv[0:4].expand_as(a)
    d = d_row.expand_as(a)
    for r in range(10):
        w = lambda j: ms[..., 16 * r + 4 * j : 16 * r + 4 * j + 4]
        a, b, c, d = _g(a, b, c, d, w(0), w(1))
        b, c, d = b.roll(-1, -1), c.roll(-2, -1), d.roll(-3, -1)
        a, b, c, d = _g(a, b, c, d, w(2), w(3))
        b, c, d = b.roll(1, -1), c.roll(2, -1), d.roll(3, -1)
    return torch.cat([h[..., 0:4] ^ a ^ c, h[..., 4:8] ^ b ^ d], dim=-1)


def bytes_to_words(data_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 4W] (little-endian) -> int64 words [..., W]."""
    b = data_u8.to(torch.int64).reshape(data_u8.shape[:-1] + (-1, 4))
    return b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16) | (b[..., 3] << 24)


def words_to_bytes(words: torch.Tensor) -> torch.Tensor:
    """int64 words [..., W] -> uint8 [..., 4W] (little-endian)."""
    parts = torch.stack([(words >> s) & 0xFF for s in (0, 8, 16, 24)], dim=-1)
    return parts.reshape(words.shape[:-1] + (4 * words.shape[-1],)).to(torch.uint8)


def blake2s_plain(data_u8: torch.Tensor, suffix_words: torch.Tensor | None = None) -> torch.Tensor:
    """Blake2s-256 of uint8 [..., n] (unkeyed, 32-byte digest), each row
    followed by its `suffix_words` (int64 [..., 8], as 32 little-endian
    bytes) when given, batched over the broadcast leading dims -> int64
    digest words [..., 8]. PyTorch ops on any device; `blake2s` takes it
    for CPU tensors."""
    if suffix_words is not None:
        tail = words_to_bytes(suffix_words)
        bshape = torch.broadcast_shapes(data_u8.shape[:-1], tail.shape[:-1])
        data_u8 = torch.cat([data_u8.expand(bshape + data_u8.shape[-1:]), tail.expand(bshape + (32,))], dim=-1)
    nbytes = data_u8.shape[-1]
    batch = data_u8.shape[:-1]
    nblocks = max(1, -(-nbytes // 64))
    pad = nblocks * 64 - nbytes
    if pad:
        data_u8 = torch.cat([data_u8, data_u8.new_zeros(batch + (pad,))], dim=-1)
    m = bytes_to_words(data_u8).reshape(batch + (nblocks, 16))
    h = _blake2s_h0(data_u8.device).expand(batch + (8,))
    for i in range(nblocks - 1):
        h = _compress(h, m[..., i, :], t=(i + 1) * 64, last=False)
    return _compress(h, m[..., nblocks - 1, :], t=nbytes, last=True)


def blake2s(data_u8: torch.Tensor, suffix_words: torch.Tensor | None = None) -> torch.Tensor:
    """`blake2s_plain`'s digest words: CPU tensors take the plain version,
    CUDA tensors one launch of the kernel (`ops/cuda/hash.py`)."""
    if data_u8.device.type == "cpu":
        return blake2s_plain(data_u8, suffix_words)
    return cuda_hash.blake2s(data_u8, suffix_words)


def blake2s_bytes(data_u8: torch.Tensor) -> torch.Tensor:
    """Blake2s digest as uint8 [..., 32] (on the card the kernel writes the
    bytes itself)."""
    if data_u8.device.type == "cpu":
        return words_to_bytes(blake2s_plain(data_u8))
    return cuda_hash.blake2s(data_u8, out_bytes=True)


def chacha20_block(key_words: torch.Tensor, counter: torch.Tensor) -> torch.Tensor:
    """ChaCha20 blocks: key words [..., 8], block counters [...] (broadcast)
    -> output words [..., 16]. 64-bit counter in words 12-13, nonce 0 (the
    `rand_chacha::ChaChaRng` layout of `crypto/transcript.py`)."""
    batch = torch.broadcast_shapes(key_words.shape[:-1], counter.shape)
    dev = key_words.device
    counter = counter.expand(batch)
    const = _chacha_const(dev).expand(batch + (4,))
    zeros = counter.new_zeros(batch)
    tail = torch.stack([counter & M32, (counter >> 32) & M32, zeros, zeros], dim=-1)
    state = torch.cat([const, key_words.expand(batch + (8,)), tail], dim=-1)
    a, b, c, d = state[..., 0:4], state[..., 4:8], state[..., 8:12], state[..., 12:16]

    def qr(a, b, c, d):
        a = (a + b) & M32
        d = _rotl(d ^ a, 16)
        c = (c + d) & M32
        b = _rotl(b ^ c, 12)
        a = (a + b) & M32
        d = _rotl(d ^ a, 8)
        c = (c + d) & M32
        b = _rotl(b ^ c, 7)
        return a, b, c, d

    for _ in range(10):
        a, b, c, d = qr(a, b, c, d)  # column round
        b, c, d = b.roll(-1, -1), c.roll(-2, -1), d.roll(-3, -1)
        a, b, c, d = qr(a, b, c, d)  # diagonal round
        b, c, d = b.roll(1, -1), c.roll(2, -1), d.roll(3, -1)
    return (torch.cat([a, b, c, d], dim=-1) + state) & M32


def chacha20_words(key_words: torch.Tensor, start_word: torch.Tensor, nwords: int) -> torch.Tensor:
    """`nwords` consecutive keystream words from word position `start_word`
    ([...] int64) of each key: int64 [..., nwords]."""
    nblocks = (15 + nwords + 15) // 16
    first = start_word // 16
    counters = first[..., None] + torch.arange(nblocks, device=start_word.device)
    stream = chacha20_block(key_words[..., None, :], counters).flatten(-2)  # [..., 16 nb]
    idx = (start_word % 16)[..., None] + torch.arange(nwords, device=start_word.device)
    return torch.gather(stream, -1, idx)
