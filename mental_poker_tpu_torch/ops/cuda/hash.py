"""The transcript's Blake2s and ChaCha20 draw as Hopper kernels.

Replaces no Pallas kernel: the JAX package computes both as jnp code
(`mental_poker_tpu/crypto/hash_jax.py`, `transcript_jax.py`). Their plain
PyTorch versions are `crypto/hash_dev.py::blake2s_plain` and
`crypto/transcript_dev.py::_draw_plain`, which dispatch here for CUDA
tensors. Source: `csrc/hash.cu`.

- What they compute: the Blake2s-256 digest of one message row a transcript
  lane (optionally followed by the lane's 32-byte seed, as `absorb` hashes
  it); and one challenge draw round of a lane (K candidates from its
  ChaCha20 keystream, the first below the modulus).
- What bounds them on the H100: 32-bit integer operations, about 1,200 a
  Blake2s compression and 1,000 a ChaCha20 block; each message byte is read
  once. The plain versions instead launch ~670 kernels a 64-byte block or a
  draw round.
- What the design does about it: one thread a lane, its whole state in
  registers or shared memory, every compression or keystream block of the
  lane in one loop, so one launch a digest or a draw.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import LAUNCHES, build

_B2S_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_DRAW_ARGS = [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def _rows(t: torch.Tensor, lanes: int, width: int) -> torch.Tensor:
    """`t` [..., width] as [lanes, width] with unit stride along a row: a
    view where the leading dims merge (a broadcast row keeps stride 0),
    else a contiguous copy."""
    r = t.reshape(lanes, width)
    return r if width <= 1 or r.stride(1) == 1 else r.contiguous()


def blake2s(data_u8: torch.Tensor, suffix_words: torch.Tensor | None = None, out_bytes: bool = False):
    """Blake2s-256 of uint8 [..., n] CUDA rows, each followed by its
    `suffix_words` (int64 [..., 8], 32 bytes little-endian) when given;
    batch dims broadcast. -> int64 digest words [..., 8], or uint8 [..., 32]
    with `out_bytes`."""
    if data_u8.device.type != "cuda":
        raise ValueError("blake2s: data must be a CUDA tensor")
    if data_u8.dtype != torch.uint8:
        raise TypeError(f"blake2s: expected uint8 data, got {data_u8.dtype}")
    n = data_u8.shape[-1]
    bshape = data_u8.shape[:-1]
    if suffix_words is not None:
        if suffix_words.device != data_u8.device or suffix_words.dtype != torch.int64:
            raise TypeError("blake2s: the suffix must be int64 words on the data's device")
        if suffix_words.shape[-1:] != (8,):
            raise ValueError(f"blake2s: expected [..., 8] suffix words, got {tuple(suffix_words.shape)}")
        bshape = torch.broadcast_shapes(bshape, suffix_words.shape[:-1])
    lanes = bshape.numel()
    out = torch.empty(bshape + ((32,) if out_bytes else (8,)),
                      dtype=torch.uint8 if out_bytes else torch.int64, device=data_u8.device)
    if lanes == 0:
        return out
    rows = _rows(data_u8.expand(bshape + (n,)), lanes, n)
    suffix, suffix_stride = None, 0
    if suffix_words is not None:
        suffix = _rows(suffix_words.expand(bshape + (8,)), lanes, 8)
        suffix_stride = suffix.stride(0)
    fn = build.function("hash.cu", "mp_blake2s", _B2S_ARGS)
    stream = torch.cuda.current_stream(data_u8.device).cuda_stream
    build.check(
        fn(rows.data_ptr(), rows.stride(0), n, None if suffix is None else suffix.data_ptr(), suffix_stride,
           lanes, None if out_bytes else out.data_ptr(), out.data_ptr() if out_bytes else None, stream),
        "blake2s",
    )
    LAUNCHES["blake2s"] += 1
    return out


@functools.cache
def _draw_words(p: int, nw: int, hi_mask: int) -> np.ndarray:
    """[p (nw little-endian words), top-word mask] for the draw's constants."""
    return np.array([(p >> (32 * j)) & 0xFFFFFFFF for j in range(nw)] + [hi_mask], np.uint32)


def chacha_draw(seed: torch.Tensor, widx: torch.Tensor, p: int, nw: int, hi_mask: int, K: int):
    """K candidate draws of `nw` words from keystream word `widx` ([...]
    int64) of each lane's ChaCha20 key `seed` (int64 [..., 8], broadcast
    against `widx`), the top word masked by `hi_mask`, on the card -> (the
    first candidate below `p` (the last candidate where none is) as
    16-bit limbs int32 [..., 2 nw], found bool [...], words consumed int64
    [...]): `transcript_dev._draw_plain`'s outputs."""
    if widx.device.type != "cuda" or seed.device != widx.device:
        raise ValueError("chacha_draw: seed and widx must be CUDA tensors on one device")
    if seed.dtype != torch.int64 or widx.dtype != torch.int64:
        raise TypeError("chacha_draw: expected int64 seed words and positions")
    if nw not in (8, 12) or K <= 0:
        raise ValueError(f"chacha_draw: nw = {nw}, K = {K} (the kernel takes nw 8 or 12 and K >= 1)")
    bshape = widx.shape
    lanes = bshape.numel()
    dev = widx.device
    value = torch.empty(bshape + (2 * nw,), dtype=torch.int32, device=dev)
    found = torch.empty(bshape, dtype=torch.bool, device=dev)
    adv = torch.empty(bshape, dtype=torch.int64, device=dev)
    if lanes == 0:
        return value, found, adv
    keys = _rows(seed.expand(bshape + (8,)), lanes, 8)
    starts = widx.reshape(lanes).contiguous()
    fn = build.function("hash.cu", "mp_chacha_draw", _DRAW_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    build.check(
        fn(nw, keys.data_ptr(), keys.stride(0), starts.data_ptr(), lanes, K, _draw_words(p, nw, hi_mask).ctypes.data,
           value.data_ptr(), found.data_ptr(), adv.data_ptr(), stream),
        "chacha_draw",
    )
    LAUNCHES["chacha_draw"] += 1
    return value, found, adv
