"""Host-side (pure Python int) short-Weierstrass curve arithmetic.

Role: the slow-but-obviously-correct reference used for (a) cross-checking the
TPU limb/curve kernels in tests, (b) host-side setup sampling (random group
elements with unknown discrete log, mirroring arkworks `UniformRand` for
`GroupProjective` which decompresses a random x — see reference use-sites
`Card::rand` at `src/discrete_log_cards/tests.rs:137` etc.), and (c) point
decompression during deserialization.

Affine coordinates; the point at infinity is represented as None coordinates
with `infinity=True`.
"""

from __future__ import annotations

import dataclasses


def sqrt_mod(n: int, p: int) -> int | None:
    """A square root of n mod p (p odd prime), or None if n is not a QR.

    Cipolla's algorithm: (a + w)^((p+1)/2) in F_p[w], w^2 = a^2 - n a
    non-residue, in about log2 p steps. Tonelli-Shanks takes about s^2 / 2
    squarings where 2^s divides p - 1, and the Stark field has s = 192, which
    made its random points (`rand_point`) five times slower. Which of the two
    roots comes back does not matter: `decompress` picks by size."""
    n %= p
    if n == 0:
        return 0
    if pow(n, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(n, (p + 1) // 4, p)
    a = 1
    while pow((a * a - n) % p, (p - 1) // 2, p) != p - 1:
        a += 1
    w2 = (a * a - n) % p
    x0, x1, r0, r1 = a, 1, 1, 0  # x = a + w, r = 1
    e = (p + 1) // 2
    while e:
        if e & 1:
            r0, r1 = (r0 * x0 + r1 * x1 * w2) % p, (r0 * x1 + r1 * x0) % p
        x0, x1 = (x0 * x0 + x1 * x1 * w2) % p, 2 * x0 * x1 % p
        e >>= 1
    return r0


@dataclasses.dataclass(frozen=True)
class HostCurve:
    """y^2 = x^3 + a*x + b over GF(p), group order `order` (prime), cofactor 1
    assumed for the protocol subgroup (points are sampled in-subgroup)."""

    name: str
    p: int
    a: int
    b: int
    order: int
    gx: int
    gy: int
    cofactor: int = 1

    # (x, y, infinity) triples
    @property
    def identity(self):
        return (0, 0, True)

    @property
    def generator(self):
        return (self.gx, self.gy, False)

    def is_on_curve(self, P) -> bool:
        x, y, inf = P
        if inf:
            return True
        return (y * y - (x * x * x + self.a * x + self.b)) % self.p == 0

    def neg(self, P):
        x, y, inf = P
        if inf:
            return P
        return (x, (-y) % self.p, False)

    def add(self, P, Q):
        p = self.p
        x1, y1, i1 = P
        x2, y2, i2 = Q
        if i1:
            return Q
        if i2:
            return P
        if x1 == x2:
            if (y1 + y2) % p == 0:
                return self.identity
            lam = (3 * x1 * x1 + self.a) * pow(2 * y1, -1, p) % p
        else:
            lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
        x3 = (lam * lam - x1 - x2) % p
        y3 = (lam * (x1 - x3) - y1) % p
        return (x3, y3, False)

    def mul(self, k: int, P):
        k %= self.order
        R = self.identity
        Q = P
        while k:
            if k & 1:
                R = self.add(R, Q)
            Q = self.add(Q, Q)
            k >>= 1
        return R

    def decompress(self, x: int, y_is_negative: bool):
        """Recover point from x and the arkworks y-sign flag.

        arkworks `SWFlags::from_y_sign(y > -y)`: the flag is set (negative)
        when the stored y is lexicographically larger than -y.
        Returns None if x is not on the curve.
        """
        rhs = (x * x * x + self.a * x + self.b) % self.p
        y = sqrt_mod(rhs, self.p)
        if y is None:
            return None
        neg_y = (-y) % self.p
        big, small = (y, neg_y) if y > neg_y else (neg_y, y)
        return (x, big if y_is_negative else small, False)

    def rand_point(self, pyrng):
        """Random curve point with unknown discrete log (arkworks
        `GroupProjective::rand` semantics: random x until on-curve, random
        y-sign, multiply by cofactor)."""
        while True:
            x = pyrng.randrange(self.p)
            sign = pyrng.randrange(2)
            P = self.decompress(x, bool(sign))
            if P is not None:
                if self.cofactor != 1:
                    P = self.mul_unbounded(self.cofactor, P)
                    if P[2]:
                        continue
                return P

    def mul_unbounded(self, k: int, P):
        R = self.identity
        Q = P
        while k:
            if k & 1:
                R = self.add(R, Q)
            Q = self.add(Q, Q)
            k >>= 1
        return R


STARK = HostCurve(
    name="stark",
    p=2**251 + 17 * 2**192 + 1,
    a=1,
    b=3141592653589793238462643383279502884197169399375105820974944592307816406665,
    order=0x0800000000000010FFFFFFFFFFFFFFFFB781126DCAE7B2321E66A241ADC64D2F,
    gx=874739451078007766457464989774322083649278607533249481151382481072868806602,
    gy=152666792071518830868575557812948353041420400780739481342941381225525861407,
)

BLS12_377_G1 = HostCurve(
    name="bls12_377_g1",
    p=0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001,
    a=0,
    b=1,
    order=0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001,
    gx=0x008848DEFE740A67C8FC6225BF87FF5485951E2CAA9D41BB188282C8BD37CB5CD5481512FFCD394EEAB9B16EB21BE9EF,
    gy=0x01914A69C5102EFF1F674F5D30AFEEC4BD7FB348CA3E52D96D182AD44FB82305C2FE3D3634A9591AFD82DE55559C8EA6,
    cofactor=0x170B5D44300000000000000000000000,
)
