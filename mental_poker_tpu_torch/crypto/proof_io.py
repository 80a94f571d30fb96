"""(De)serialization of protocol proofs — arkworks `CanonicalSerialize`
compressed layout (counterpart of `mental_poker_tpu/crypto/proof_io.py`, the
same bytes; the reference measures proof sizes on this layout at
`examples/parameter_selection.rs:95`, and every public proof type carries
CanonicalSerialize bounds, `src/lib.rs:45-71`).

Every protocol artifact (keys, cards, proofs) is byte-serializable, which is
the reference's checkpoint/persistence story (SURVEY §5): game state can be
persisted or transmitted at any step and reloaded losslessly.

Layout conventions (ark-serialize 0.3):
- compressed point  = LE bytes of x, SWFlags in the top byte (serialize.py);
- scalar            = LE canonical bytes sized to the 64-bit-word repr;
- sequences are length-prefixed with a u64 LE (arkworks Vec layout).
"""

from __future__ import annotations

import io
import struct

from ..arguments.hadamard import HadamardProof
from ..arguments.multi_exponentiation import MultiExpProof
from ..arguments.product import ProductProof
from ..arguments.shuffle import ShuffleProof
from ..arguments.single_value_product import SVPProof
from ..arguments.zero import ZeroProof
from ..utils.host_curve import HostCurve
from . import serialize as ser
from .sigma import ChaumPedersenProof, SchnorrProof


class _W:
    def __init__(self, curve: HostCurve):
        self.curve = curve
        self.buf = io.BytesIO()

    def point(self, P):
        self.buf.write(ser.point_to_bytes_compressed(P, self.curve))

    def points(self, ps):
        self.buf.write(struct.pack("<Q", len(ps)))
        for p in ps:
            self.point(p)

    def cipher(self, pair):
        self.point(pair[0])
        self.point(pair[1])

    def ciphers(self, pairs):
        self.buf.write(struct.pack("<Q", len(pairs)))
        for p in pairs:
            self.cipher(p)

    def scalar(self, x: int):
        self.buf.write(ser.scalar_to_bytes(x, self.curve.order.bit_length()))

    def scalars(self, xs):
        self.buf.write(struct.pack("<Q", len(xs)))
        for x in xs:
            self.scalar(x)

    def getvalue(self) -> bytes:
        return self.buf.getvalue()


class _R:
    def __init__(self, curve: HostCurve, data: bytes):
        self.curve = curve
        self.buf = io.BytesIO(data)
        self.psize = ser.compressed_point_size(curve)
        self.ssize = ser.scalar_size(curve)

    def point(self):
        return ser.point_from_bytes_compressed(self.buf.read(self.psize), self.curve)

    def points(self):
        (n,) = struct.unpack("<Q", self.buf.read(8))
        return [self.point() for _ in range(n)]

    def cipher(self):
        return (self.point(), self.point())

    def ciphers(self):
        (n,) = struct.unpack("<Q", self.buf.read(8))
        return [self.cipher() for _ in range(n)]

    def scalar(self) -> int:
        return ser.field_from_bytes(self.buf.read(self.ssize))

    def scalars(self):
        (n,) = struct.unpack("<Q", self.buf.read(8))
        return [self.scalar() for _ in range(n)]


# --------------------------------------------------------------- sigma proofs
def schnorr_to_bytes(proof: SchnorrProof, curve: HostCurve) -> bytes:
    w = _W(curve)
    w.points(proof.commit)
    w.scalars(proof.response)
    return w.getvalue()


def schnorr_from_bytes(data: bytes, curve: HostCurve) -> SchnorrProof:
    r = _R(curve, data)
    return SchnorrProof(r.points(), r.scalars())


def chaum_pedersen_to_bytes(proof: ChaumPedersenProof, curve: HostCurve) -> bytes:
    w = _W(curve)
    w.points(proof.t_g)
    w.points(proof.t_h)
    w.scalars(proof.response)
    return w.getvalue()


def chaum_pedersen_from_bytes(data: bytes, curve: HostCurve, shape=()) -> ChaumPedersenProof:
    r = _R(curve, data)
    p = ChaumPedersenProof(r.points(), r.points(), r.scalars())
    return ChaumPedersenProof(p.t_g, p.t_h, p.response, shape or (len(p.t_g),))


# -------------------------------------------------------------- shuffle proof
def shuffle_to_bytes(proof: ShuffleProof, curve: HostCurve) -> bytes:
    w = _W(curve)
    w.points(proof.c_a)
    w.points(proof.c_b)
    # product argument
    pr = proof.product
    w.point(pr.c_b)
    w.points(pr.hadamard.c_B_mid)
    z = pr.hadamard.zero
    w.point(z.c_a0)
    w.point(z.c_bm1)
    w.points(z.c_d)
    w.scalars(z.a)
    w.scalar(z.r)
    w.scalars(z.b)
    w.scalar(z.s)
    w.scalar(z.t)
    sv = pr.svp
    w.point(sv.c_d)
    w.point(sv.c_delta)
    w.point(sv.c_Delta)
    w.scalars(sv.a_tilde)
    w.scalar(sv.r_tilde)
    w.scalars(sv.b_tilde)
    w.scalar(sv.s_tilde)
    # multi-exponentiation argument
    me = proof.multi_exp
    w.point(me.c_a0)
    w.points(me.c_b)
    w.ciphers(me.e)
    w.scalars(me.a)
    w.scalar(me.r)
    w.scalar(me.b)
    w.scalar(me.s)
    w.scalar(me.tau)
    return w.getvalue()


def shuffle_from_bytes(data: bytes, curve: HostCurve) -> ShuffleProof:
    r = _R(curve, data)
    c_a = r.points()
    c_b = r.points()
    pc_b = r.point()
    c_B_mid = r.points()
    z = ZeroProof(r.point(), r.point(), r.points(), r.scalars(), r.scalar(),
                  r.scalars(), r.scalar(), r.scalar())
    sv = SVPProof(r.point(), r.point(), r.point(), r.scalars(), r.scalar(),
                  r.scalars(), r.scalar())
    product = ProductProof(pc_b, HadamardProof(c_B_mid, z), sv)
    me = MultiExpProof(r.point(), r.points(), r.ciphers(), r.scalars(),
                       r.scalar(), r.scalar(), r.scalar(), r.scalar())
    return ShuffleProof(c_a, c_b, product, me)


def shuffle_proof_size(proof: ShuffleProof, curve: HostCurve) -> int:
    """Serialized size in bytes (the `parameter_selection.rs:95` metric)."""
    return len(shuffle_to_bytes(proof, curve))
