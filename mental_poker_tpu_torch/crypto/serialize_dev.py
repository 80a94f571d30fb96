"""Device-side arkworks byte layouts (counterpart of
`mental_poker_tpu/crypto/serialize_jax.py`).

Builds the exact `ToBytes` blobs the transcript absorbs, as uint8 tensors:
a field element is its canonical little-endian bytes at the 64-bit-word
repr width (2L bytes for every field here); an affine point is
x || y || infinity byte, and the identity writes 0 || 1 || 1.
"""

from __future__ import annotations

import functools

import torch


def limbs_to_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical 16-bit limbs [..., L] -> uint8 [..., 2L] little-endian."""
    out = torch.stack([limbs & 0xFF, (limbs >> 8) & 0xFF], dim=-1)
    return out.flatten(-2).to(torch.uint8)


def bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., 2L] little-endian -> int32 16-bit limbs [..., L]."""
    v = b.to(torch.int32).reshape(b.shape[:-1] + (-1, 2))
    return v[..., 0] | (v[..., 1] << 8)


def field_bytes(fld, canonical_limbs: torch.Tensor) -> torch.Tensor:
    """arkworks ToBytes of canonical field elements."""
    repr_len = 8 * (-(-fld.p.bit_length() // 64))
    if 2 * fld.L != repr_len:
        raise ValueError(f"{fld.name}: limb width {fld.L} does not match the {repr_len}-byte repr")
    return limbs_to_bytes(canonical_limbs)


def affine_bytes(cv, x_m: torch.Tensor, y_m: torch.Tensor, inf: torch.Tensor) -> torch.Tensor:
    """ToBytes from affine Montgomery coordinates: uint8 [..., 4L + 1]."""
    f = cv.fq
    xb = field_bytes(f, f.from_mont(x_m))
    yb = field_bytes(f, f.from_mont(y_m))
    return torch.cat([xb, yb, inf[..., None].to(torch.uint8)], dim=-1)


def point_bytes(cv, P) -> torch.Tensor:
    """ToBytes of projective points (normalised to affine): [..., 4L + 1]."""
    return affine_bytes(cv, *cv.to_affine(P))


def points_blob(cv, P) -> torch.Tensor:
    """Points' ToBytes concatenated over the last point axis."""
    pb = point_bytes(cv, P)
    return pb if pb.dim() == 1 else pb.flatten(-2)


@functools.cache
def _bytes_tensor(data: bytes, device: torch.device) -> torch.Tensor:
    return torch.tensor(list(data), dtype=torch.uint8, device=device)


def const_bytes(data: bytes, batch_shape: tuple = (), device="cuda") -> torch.Tensor:
    """Static bytes as a (broadcast) uint8 tensor, copied to the device once
    per value and device."""
    arr = _bytes_tensor(bytes(data), torch.device(device))
    return arr.expand(tuple(batch_shape) + arr.shape)


def u64_le_bytes(value: int, batch_shape: tuple = (), device="cuda") -> torch.Tensor:
    """A static u64 as 8 little-endian bytes."""
    return const_bytes(int(value).to_bytes(8, "little"), batch_shape, device)


def concat_bytes(*blobs: torch.Tensor) -> torch.Tensor:
    """Concatenate byte blobs on the last axis, broadcasting batch dims."""
    bshape = torch.broadcast_shapes(*(b.shape[:-1] for b in blobs))
    return torch.cat([b.expand(bshape + b.shape[-1:]) for b in blobs], dim=-1)
