"""The Stark curve in Python integers: the benchmark's plain reference for
every point the program computes.

y^2 = x^3 + x + b over GF(p), prime order q. Affine points are (x, y, inf)
triples with canonical coordinates, the identity (0, 0, True); inside a
computation points are Jacobian (X, Y, Z), x = X / Z^2, y = Y / Z^3, the
identity Z = 0. A multi-scalar product is a Straus walk over 4-bit windows
(one doubling chain shared by every point), which keeps a sampled proof's
verification well under a second.
"""

from __future__ import annotations

P = 2**251 + 17 * 2**192 + 1
A = 1
B = 3141592653589793238462643383279502884197169399375105820974944592307816406665
Q = 0x0800000000000010FFFFFFFFFFFFFFFFB781126DCAE7B2321E66A241ADC64D2F
Q_BITS = Q.bit_length()
P_BYTES = 32  # arkworks ToBytes: 4 64-bit words
WINDOW = 4
WINDOWS = -(-Q_BITS // WINDOW)

IDENTITY = (0, 0, True)
J_IDENTITY = (1, 1, 0)


def sqrt_mod(n: int) -> int | None:
    """A square root of n mod p by Cipolla's method, or None."""
    n %= P
    if n == 0:
        return 0
    if pow(n, (P - 1) // 2, P) != 1:
        return None
    a = 1
    while pow((a * a - n) % P, (P - 1) // 2, P) != P - 1:
        a += 1
    w2 = (a * a - n) % P
    x0, x1, r0, r1 = a, 1, 1, 0
    e = (P + 1) // 2
    while e:
        if e & 1:
            r0, r1 = (r0 * x0 + r1 * x1 * w2) % P, (r0 * x1 + r1 * x0) % P
        x0, x1 = (x0 * x0 + x1 * x1 * w2) % P, 2 * x0 * x1 % P
        e >>= 1
    return r0


def point_from_x(x: int, odd_y: bool):
    """The point with this x and the y of the given parity, or None."""
    y = sqrt_mod(x * x * x + A * x + B)
    if y is None:
        return None
    if (y & 1) != odd_y:
        y = P - y
    return (x % P, y, False)


def to_jac(pt):
    x, y, inf = pt
    return J_IDENTITY if inf else (x, y, 1)


def to_affine(j):
    X, Y, Z = j
    if Z % P == 0:
        return IDENTITY
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P, False)


def jdbl(j):
    X, Y, Z = j
    if Z == 0 or Y == 0:
        return J_IDENTITY
    YY = Y * Y % P
    S = 4 * X * YY % P
    Z2 = Z * Z % P
    M = (3 * X * X + A * Z2 * Z2) % P
    X3 = (M * M - 2 * S) % P
    Y3 = (M * (S - X3) - 8 * YY * YY) % P
    return (X3, Y3, 2 * Y * Z % P)


def jadd(j1, j2):
    X1, Y1, Z1 = j1
    X2, Y2, Z2 = j2
    if Z1 == 0:
        return j2
    if Z2 == 0:
        return j1
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    H = (U2 - U1) % P
    R = (S2 - S1) % P
    if H == 0:
        return jdbl(j1) if R == 0 else J_IDENTITY
    HH = H * H % P
    HHH = H * HH % P
    V = U1 * HH % P
    X3 = (R * R - HHH - 2 * V) % P
    Y3 = (R * (V - X3) - S1 * HHH) % P
    return (X3, Y3, Z1 * Z2 % P * H % P)


def add(a, b):
    return to_affine(jadd(to_jac(a), to_jac(b)))


def neg(a):
    x, y, inf = a
    return a if inf else (x, (-y) % P, False)


def _multiples(j) -> list:
    row = [J_IDENTITY, j]
    for _ in range((1 << WINDOW) - 2):
        row.append(jadd(row[-1], j))
    return row


def msm_jac(points, scalars):
    """sum_i scalars[i] * points[i] (affine points, ints) -> Jacobian."""
    tables, digits = [], []
    for pt, k in zip(points, scalars):
        k %= Q
        if k == 0 or pt[2]:
            continue
        tables.append(_multiples(to_jac(pt)))
        digits.append(k)
    acc = J_IDENTITY
    mask = (1 << WINDOW) - 1
    for w in range(WINDOWS - 1, -1, -1):
        for _ in range(WINDOW):
            acc = jdbl(acc)
        shift = w * WINDOW
        for table, k in zip(tables, digits):
            d = (k >> shift) & mask
            if d:
                acc = jadd(acc, table[d])
    return acc


def msm(points, scalars):
    return to_affine(msm_jac(points, scalars))


def mul(k: int, pt):
    return msm([pt], [k])


class FixedBase:
    """Window table of one base for many products: row w holds
    d * 2^(4w) * base, so a product is one addition a window."""

    def __init__(self, pt):
        self.rows = []
        j = to_jac(pt)
        for _ in range(WINDOWS):
            self.rows.append(_multiples(j))
            for _ in range(WINDOW):
                j = jdbl(j)

    def mul_jac(self, k: int):
        k %= Q
        acc = J_IDENTITY
        mask = (1 << WINDOW) - 1
        for w, row in enumerate(self.rows):
            d = (k >> (w * WINDOW)) & mask
            if d:
                acc = jadd(acc, row[d])
        return acc


def point_bytes(pt) -> bytes:
    """arkworks ToBytes of an affine point: x || y || infinity byte; the
    identity writes x = 0, y = 1."""
    x, y, inf = pt
    if inf:
        return (0).to_bytes(P_BYTES, "little") + (1).to_bytes(P_BYTES, "little") + b"\x01"
    return x.to_bytes(P_BYTES, "little") + y.to_bytes(P_BYTES, "little") + b"\x00"
