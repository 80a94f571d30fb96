"""arkworks-compatible byte layouts (role of `ark-serialize` in the reference).

A copy of `mental_poker_tpu/crypto/serialize.py` (host code, Python ints), kept
here so the port imports nothing of the JAX package.

Two layouts are used by the reference:

- `ToBytes` / `to_bytes![...]` (ark-ff 0.3): used to build Fiat-Shamir seeds
  (`src/discrete_log_cards/mod.rs:140,202,232,...`). Field elements write the
  canonical (non-Montgomery) representation as little-endian bytes sized to the
  64-bit-word repr; affine points write `x || y || infinity_byte`.
- `CanonicalSerialize` (compressed): bound on every public protocol type
  (`src/lib.rs:45-71`); proof sizes are measured on this layout
  (`examples/parameter_selection.rs:95`). Compressed points store x with two
  flag bits in the top byte: bit7 = negative-y (y lexicographically larger
  than -y), bit6 = infinity.

All functions are host-side and operate on Python ints.
"""

from __future__ import annotations

from ..utils.host_curve import HostCurve


def repr_bytes(bits: int) -> int:
    """Byte length of the arkworks BigInteger repr for a `bits`-bit modulus
    (64-bit words, i.e. 8-byte multiples)."""
    words = -(-bits // 64)
    return words * 8


def field_to_bytes(x: int, modulus_bits: int) -> bytes:
    return int(x).to_bytes(repr_bytes(modulus_bits), "little")


def field_from_bytes(b: bytes) -> int:
    return int.from_bytes(b, "little")


def point_to_bytes(P, curve: HostCurve) -> bytes:
    """arkworks `ToBytes` layout for affine points: x || y || infinity(u8).

    GroupAffine::zero() is (x=0, y=1, infinity=true) in arkworks, and ToBytes
    writes the stored coordinates, so infinity serializes as 0 || 1 || 1.
    """
    x, y, inf = P
    nb = curve.p.bit_length()
    if inf:
        return field_to_bytes(0, nb) + field_to_bytes(1, nb) + b"\x01"
    return field_to_bytes(x, nb) + field_to_bytes(y, nb) + b"\x00"


def point_to_bytes_compressed(P, curve: HostCurve) -> bytes:
    """arkworks `CanonicalSerialize` (compressed) for short-Weierstrass affine.

    Layout: LE bytes of x with SWFlags OR'd into the most significant byte:
    negative-y = 1<<7, infinity = 1<<6 (ark-serialize 0.3 `SWFlags`).
    """
    x, y, inf = P
    nb = curve.p.bit_length()
    if inf:
        data = bytearray(field_to_bytes(0, nb))
        data[-1] |= 1 << 6
        return bytes(data)
    neg_y = (-y) % curve.p
    flag = (1 << 7) if y > neg_y else 0
    data = bytearray(field_to_bytes(x, nb))
    data[-1] |= flag
    return bytes(data)


def point_from_bytes_compressed(b: bytes, curve: HostCurve):
    """Inverse of `point_to_bytes_compressed` (does curve decompression)."""
    data = bytearray(b)
    flags = data[-1] & 0xC0
    data[-1] &= 0x3F
    x = int.from_bytes(bytes(data), "little")
    if flags & (1 << 6):
        return curve.identity
    P = curve.decompress(x, bool(flags & (1 << 7)))
    if P is None:
        raise ValueError("invalid compressed point")
    return P


def scalar_to_bytes(x: int, order_bits: int) -> bytes:
    """Canonical scalar serialization (both ToBytes and CanonicalSerialize)."""
    return field_to_bytes(x, order_bits)


def compressed_point_size(curve: HostCurve) -> int:
    return repr_bytes(curve.p.bit_length())


def scalar_size(curve: HostCurve) -> int:
    return repr_bytes(curve.order.bit_length())
