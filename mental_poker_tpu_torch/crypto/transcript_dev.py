"""Device-resident Fiat-Shamir transcript (counterpart of
`mental_poker_tpu/crypto/transcript_jax.py`; ark-marlin `FiatShamirRng<Blake2s>`
semantics, bit-exact with the host `crypto/transcript.py`).

    state = (seed: int64 words [..., 8], widx: int64 [...])

- ``absorb``: seed' = Blake2s(data || seed bytes); the keystream restarts.
- ``sample_field``: arkworks ``UniformRand``: draw the 64-bit-word repr
  from the ChaCha20 word stream, mask the top word, reject until < modulus,
  and read the accepted words as the Montgomery representation (for every
  field here the arkworks R equals the limb R = 2^(16 L)).

Every lane of a batch is an independent transcript: a rejected lane draws
again from its own stream while accepted lanes stop consuming words.

``sample_field_once`` is the draw of the fused latency mode
(`arguments/fused.py`): one round of `FUSED_CANDIDATES` candidates and no
host sync, so that a CUDA graph can hold it. A lane advances to its first
accepted candidate, as the loop's does, so the two give the same values
and positions wherever every lane accepts within the round; a lane that
does not is reported undone, and its caller runs the draw again the loop's
way.
"""

from __future__ import annotations

import functools
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from ..ops.cuda import hash as cuda_hash
from .hash_dev import blake2s, chacha20_words

# Candidates drawn per rejection round: a round computes this many
# consecutive draws of every lane at once and keeps the first accepted one,
# which is exactly where the one-draw-at-a-time loop would stop.
CANDIDATES = 8
# Candidates of `sample_field_once`'s single round. A Stark Fr draw is
# accepted with probability about 1/2, so a lane misses all 64 with
# probability about 2^-64.
FUSED_CANDIDATES = 64


class DTState(NamedTuple):
    seed: torch.Tensor  # int64 [..., 8] Blake2s seed words
    widx: torch.Tensor  # int64 [...] keystream word position


@functools.cache
def _seed_words(seed_bytes: bytes, device: torch.device) -> torch.Tensor:
    words = np.frombuffer(hashlib.blake2s(seed_bytes).digest(), dtype="<u4").astype(np.int64)
    return torch.as_tensor(words, device=device)


def init(seed_bytes: bytes, batch_shape: tuple = (), device="cuda") -> DTState:
    """Transcript from a domain-separation seed (digest taken on the host
    once per seed and device)."""
    seed = _seed_words(seed_bytes, torch.device(device)).expand(tuple(batch_shape) + (8,))
    return DTState(seed, torch.zeros(tuple(batch_shape), dtype=torch.int64, device=device))


def absorb(state: DTState, data_u8: torch.Tensor) -> DTState:
    """seed' = Blake2s(data || seed bytes); `data_u8` uint8 [..., n] with
    batch dims broadcastable against the state's."""
    new_seed = blake2s(data_u8, state.seed)
    return DTState(new_seed, torch.zeros(new_seed.shape[:-1], dtype=torch.int64, device=new_seed.device))


def _uniform_spec(fld):
    """(u32 words per draw, mask of the top word)."""
    bits = fld.p.bit_length()
    words64 = -(-bits // 64)
    if 16 * fld.L != 64 * words64:
        raise ValueError(f"limb R != arkworks R for {fld.name}: Montgomery reading would be wrong")
    top64 = ((1 << 64) - 1) >> (64 * words64 - bits)
    return 2 * words64, top64 >> 32


def _words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """u32 words [..., W] -> 16-bit limbs [..., 2W] (int32)."""
    limbs = torch.stack([words & 0xFFFF, words >> 16], dim=-1)
    return limbs.flatten(-2).to(torch.int32)


def _draw_plain(seed: torch.Tensor, widx: torch.Tensor, fld, K: int):
    """K consecutive candidate draws of every lane from word `widx` ->
    (the first accepted value [..., L] (the last candidate where none is),
    whether a draw was accepted [...], the words consumed [...]: up to and
    including the accepted draw, or all K draws' when none was). PyTorch
    ops on any device; `_draw` takes it for CPU tensors."""
    nw, hi_mask = _uniform_spec(fld)
    bshape = widx.shape
    words = chacha20_words(seed, widx, nw * K).reshape(bshape + (K, nw)).clone()
    words[..., nw - 1] &= hi_mask
    cand = _words_to_limbs(words)  # [..., K, L]
    ok = fld.canonical_lt(cand, fld.const("p_limbs", widx.device))  # [..., K]
    # first accepted candidate per lane (K where none is)
    first = torch.where(ok, torch.arange(K, device=widx.device), K).min(dim=-1).values
    found = first < K
    pick = torch.gather(cand, -2, first.clamp(max=K - 1)[..., None, None].expand(bshape + (1, fld.L)))
    return pick[..., 0, :], found, torch.where(found, (first + 1) * nw, K * nw)


def _draw(seed: torch.Tensor, widx: torch.Tensor, fld, K: int):
    """`_draw_plain`'s three outputs: CPU tensors take the plain version,
    CUDA tensors one launch of the draw kernel (`ops/cuda/hash.py`)."""
    if widx.device.type == "cpu":
        return _draw_plain(seed, widx, fld, K)
    nw, hi_mask = _uniform_spec(fld)
    return cuda_hash.chacha_draw(seed, widx, fld.p, nw, hi_mask, K)


def sample_field(state: DTState, fld):
    """-> (state', Montgomery-form limbs int32 [..., L])."""
    bshape = state.widx.shape
    widx = state.widx
    out = torch.zeros(bshape + (fld.L,), dtype=torch.int32, device=widx.device)
    done = torch.zeros(bshape, dtype=torch.bool, device=widx.device)
    while True:
        pick, found, adv = _draw(state.seed, widx, fld, CANDIDATES)
        found = ~done & found
        out = torch.where(found[..., None], pick, out)
        widx = torch.where(done, widx, widx + adv)
        done = done | found
        if bool(done.all()):
            return DTState(state.seed, widx), out


def sample_field_once(state: DTState, fld):
    """One round of `FUSED_CANDIDATES` draws, no host sync -> (state',
    Montgomery-form limbs int32 [..., L], undone bool [...]). Where a lane
    is undone its value and position are not `sample_field`'s."""
    pick, found, adv = _draw(state.seed, state.widx, fld, FUSED_CANDIDATES)
    return DTState(state.seed, state.widx + adv), pick, ~found


def sample_fields(state: DTState, fld, k: int):
    """k sequential draws -> (state', limbs [..., k, L])."""
    outs = []
    for _ in range(k):
        state, v = sample_field(state, fld)
        outs.append(v)
    return state, torch.stack(outs, dim=-2)
