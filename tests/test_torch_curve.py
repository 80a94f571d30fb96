"""The port's `Curve` and its point-addition wrapper against the JAX `Curve`
and the host bigint curve, on the CPU (the wrapper's plain version).

Points come from a seeded `random.Random` (k * G on the host). Tolerance:
exact equality, of projective limbs where both packages run the same
formula (`add`), of affine values otherwise.
"""

import random

import numpy as np
import pytest
import torch

from mental_poker_tpu.ops import curve as jcurve
from mental_poker_tpu.ops.curve import PointP as JPointP
from mental_poker_tpu.utils.rand import ints_to_limbs
from mental_poker_tpu_torch.ops import curve as tcurve
from mental_poker_tpu_torch.ops.curve import PointP
from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve

from _torch_bridge import dense_below_p, one_torch_thread, to_np, to_torch  # noqa: F401

CURVES = ["stark_curve", "bls12_377_g1"]


def _points(cv, n, seed):
    rng = random.Random(seed)
    return [cv.host.mul(rng.randrange(1, cv.host.order), cv.host.generator) for _ in range(n)]


def _pair(name):
    return getattr(jcurve, name)(), getattr(tcurve, name)()


@pytest.mark.parametrize("name", CURVES)
def test_add_matches_jax_and_host(name):
    jc, tc = _pair(name)
    h = jc.host
    ps = _points(jc, 5, 1)
    qs = _points(jc, 5, 2)
    # complete-formula cases: O+Q, P+O, P+P, P+(-P), O+O
    ps += [h.identity, ps[0], ps[1], ps[2], h.identity]
    qs += [qs[0], h.identity, ps[1], h.neg(ps[2]), h.identity]
    JP, JQ = jc.from_host_points(ps), jc.from_host_points(qs)
    TP = PointP(*(to_torch(c) for c in JP))
    TQ = PointP(*(to_torch(c) for c in JQ))
    got = tc.add(TP, TQ)
    want = jc.add(JP, JQ)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))
    assert tc.to_host_points(got) == [h.add(p, q) for p, q in zip(ps, qs)]
    assert tc.to_host_points(tc.dbl(TP)) == [h.add(p, p) for p in ps]
    with pytest.raises(ValueError):
        cuda_curve.point_add_cuda(tc, TP, TQ)


def _rcb_add_host(cv, P, Q):
    """RCB15 Algorithm 1 on Montgomery-form ints (products u v R^-1 mod p)."""
    p = cv.fq.p
    R = 1 << (16 * cv.fq.L)
    Ri = pow(R, -1, p)
    mul = lambda u, v: u * v * Ri % p
    a, b3 = cv.a_int * R % p, 3 * cv.host.b * R % p
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
    t3 = mul(X1 + Y1, X2 + Y2) - t0 - t1
    t4 = mul(X1 + Z1, X2 + Z2) - t0 - t2
    t5 = mul(Y1 + Z1, Y2 + Z2) - t1 - t2
    Z3 = mul(a, t4) + mul(b3, t2)
    X3, Z3 = t1 - Z3, t1 + Z3
    Y3 = mul(X3, Z3)
    t1 = 3 * t0 + mul(a, t2)
    t4 = mul(b3, t4) + mul(a, t0 - mul(a, t2))
    Y3 = Y3 + mul(t1, t4)
    X3 = mul(X3, t3) - mul(t5, t4)
    Z3 = mul(t5, Z3) + mul(t3, t1)
    return X3 % p, Y3 % p, Z3 % p


@pytest.mark.parametrize("name", CURVES)
def test_plain_add_exact_at_operand_bounds(name):
    """`point_add_plain` keeps sums and differences unreduced; feed it the
    largest coordinates (p - 1, p - 2, a dense value below p whose lower
    limbs are all 0xFFFF, 0) in every role, doubling included, and hold
    each limb of the result against the formula in host ints. A real point
    scaled to X = p - 1 doubles to the host's double."""
    tc = getattr(tcurve, name)()
    p, L = tc.fq.p, tc.fq.L
    dense = dense_below_p(p, L)
    near = [p - 1, p - 2, dense, dense - 1, 0]
    rng = random.Random(6)
    ps = [(p - 1,) * 3, (dense,) * 3, (p - 1, dense, p - 1), (0, p - 1, 0)]
    qs = [(p - 1,) * 3, (dense,) * 3, (dense, p - 1, dense), (p - 1, 0, p - 1)]
    for i in range(12):
        P = tuple(rng.choice(near) for _ in range(3))
        ps.append(P)
        qs.append(P if i % 2 else tuple(rng.choice(near) for _ in range(3)))
    pt = _points(tc, 1, 7)[0]
    X, Y, Z = (v * tc.fq.R % p for v in (pt[0], pt[1], 1))
    lam = (p - 1) * pow(X, -1, p) % p
    scaled = (p - 1, Y * lam % p, Z * lam % p)
    ps.append(scaled)
    qs.append(scaled)
    coords = lambda pts: [torch.as_tensor(ints_to_limbs([P[j] for P in pts], L).astype(np.int32)) for j in range(3)]
    got = cuda_curve.point_add_plain(tc, coords(ps), coords(qs))
    rows = lambda t: [sum(int(x) << (16 * i) for i, x in enumerate(r)) for r in t.tolist()]
    assert list(zip(*(rows(t) for t in got))) == [_rcb_add_host(tc, P, Q) for P, Q in zip(ps, qs)]
    assert tc.to_host_points(PointP(*(t[-1:] for t in got))) == [tc.host.add(pt, pt)]


@pytest.mark.parametrize("name", CURVES)
def test_scalar_mul_sum_points_to_affine(name):
    jc, tc = _pair(name)
    h = jc.host
    q = h.order
    pts = _points(jc, 4, 3) + [h.identity]
    ks = [0, 1, q - 1, random.Random(4).randrange(q), 5]
    JP = jc.from_host_points(pts)
    TP = tc.from_host_points(pts, "cpu")
    for c in TP:
        assert c.dtype == torch.int32
    k = ints_to_limbs(ks, jc.fr.L)
    got = tc.scalar_mul(to_torch(k), TP)
    assert tc.to_host_points(got) == [h.mul(kk, p) for kk, p in zip(ks, pts)]
    want = jc.scalar_mul(k, JP)
    assert tc.to_host_points(got) == jc.to_host_points(want)
    s = tc.sum_points(TP, axis=0)
    acc = h.identity
    for p in pts:
        acc = h.add(acc, p)
    assert tc.to_host_points(PointP(*(c[None] for c in s))) == [acc]
    x, y, inf = tc.to_affine(got)
    jx, jy, jinf = jc.to_affine(JPointP(*(np.asarray(to_np(c)) for c in got)))
    np.testing.assert_array_equal(to_np(x), np.asarray(jx))
    np.testing.assert_array_equal(to_np(y), np.asarray(jy))
    np.testing.assert_array_equal(to_np(inf), np.asarray(jinf))
    assert bool(tc.eq(got, tc.from_host_points(jc.to_host_points(want), "cpu")).all())


def test_multiples_table_and_select():
    jc, tc = _pair("stark_curve")
    pts = _points(jc, 2, 5)
    TP = tc.from_host_points(pts, "cpu")
    table = tc.multiples_table(TP, 2)  # [2, 4, L]
    hosts = [tc.to_host_points(PointP(*(c[:, d] for c in table))) for d in range(4)]
    for d in range(4):
        assert hosts[d] == [jc.host.mul(d, p) for p in pts]
    sel = tc.select(torch.tensor([True, False]), TP, tc.neg(TP))
    assert tc.to_host_points(sel) == [pts[0], jc.host.neg(pts[1])]
    assert tc.is_identity(tc.identity((3,), "cpu")).all()


def _stark_with_a(a):
    """The Stark field and order under another curve constant a (L = 16):
    not a curve anyone uses, only a holder of a."""
    st = tcurve.stark_curve()
    h = st.host
    host = type(h)(name=f"stark_a{a}", p=h.p, a=a, b=h.b, order=h.order, gx=h.gx, gy=h.gy)
    return tcurve.Curve(host, st.fq, st.fr)


def test_kernel_a_case_from_curve_a():
    """The kernels' compile-time a-case comes from the curve's a, not from its
    limb count: Stark (a = 1, L = 16), BLS12-377 (a = 0, L = 24), the toy
    curve of test_torch_chunked.py (a = 1, L = 2) and Stark's field with
    a = 3 or a = p - 1 (L = 16, the general case)."""
    from test_torch_chunked import _toy_curve

    assert cuda_curve.a_case(tcurve.stark_curve()) == cuda_curve.A_ONE
    assert cuda_curve.a_case(tcurve.bls12_377_g1()) == cuda_curve.A_ZERO
    assert _toy_curve().fq.L == 2 and cuda_curve.a_case(_toy_curve()) == cuda_curve.A_ONE
    for a in (3, tcurve.stark_curve().fq.p - 1):
        cv = _stark_with_a(a)
        assert cv.fq.L == 16 and cuda_curve.a_case(cv) == cuda_curve.A_GENERAL


def _rcb_add_host_case(cv, P, Q, case):
    """RCB15 Algorithm 1 on Montgomery-form ints in the kernels' order, with
    the products by a as the kernels' a-case has them: a copy for a = 1, zero
    for a = 0, a product otherwise."""
    p = cv.fq.p
    R = 1 << (16 * cv.fq.L)
    Ri = pow(R, -1, p)
    mul = lambda u, v: u * v * Ri % p
    by_a = {cuda_curve.A_ZERO: lambda u: 0, cuda_curve.A_ONE: lambda u: u % p}.get(
        case, lambda u: mul(cv.a_int * R % p, u % p))
    b3 = 3 * cv.host.b * R % p
    X1, Y1, Z1 = P
    X2, Y2, Z2 = Q
    t0, t1, t2 = mul(X1, X2), mul(Y1, Y2), mul(Z1, Z2)
    t3 = (mul(X1 + Y1, X2 + Y2) - t0 - t1) % p
    t4 = (mul(X1 + Z1, X2 + Z2) - t0 - t2) % p
    t5 = (mul(Y1 + Z1, Y2 + Z2) - t1 - t2) % p
    z3p = (mul(t2, b3) + by_a(t4)) % p
    t4b = (mul(t4, b3) + by_a(t0 - t2)) % p
    t1b = (3 * t0 + by_a(t2)) % p
    x3a, z3a = (t1 - z3p) % p, (t1 + z3p) % p
    X3 = (mul(x3a, t3) - mul(t5, t4b)) % p
    Y3 = (mul(x3a, z3a) + mul(t1b, t4b)) % p
    Z3 = (mul(t5, z3a) + mul(t3, t1b)) % p
    return X3, Y3, Z3


@pytest.mark.parametrize("name", CURVES)
def test_a_case_keeps_the_general_triple(name):
    """With the products by a replaced as the curve's a-case says (a copy on
    Stark, zero on BLS12-377), Algorithm 1 gives the general schedule's
    projective triple, in host ints, on random points and random projective
    scalings of them, doubling included."""
    tc = getattr(tcurve, name)()
    case = cuda_curve.a_case(tc)
    assert case != cuda_curve.A_GENERAL
    p, R = tc.fq.p, tc.fq.R
    rng = random.Random(11)
    pts = []
    for P in _points(tc, 8, 10) + [tc.host.identity]:
        lam = rng.randrange(1, p)
        x, y, z = (0, 1, 0) if P[2] else (P[0], P[1], 1)
        pts.append(tuple(v * lam % p * R % p for v in (x, y, z)))
    pairs = [(P, Q) for P in pts for Q in pts[::3]] + [(P, P) for P in pts]
    for P, Q in pairs:
        want = _rcb_add_host(tc, P, Q)
        assert _rcb_add_host_case(tc, P, Q, case) == want
        assert _rcb_add_host_case(tc, P, Q, cuda_curve.A_GENERAL) == want


@pytest.mark.parametrize("name", CURVES)
def test_host_sqrt_and_rand_point_match_jax(name):
    """The port's host square root (Cipolla) against the JAX package's
    Tonelli-Shanks, up to sign, over each curve's base and scalar fields;
    and the random points that the port's and the JAX package's host curves
    draw from one seed (`decompress` picks the root by size)."""
    from mental_poker_tpu.utils.host_curve import tonelli_shanks
    from mental_poker_tpu_torch.utils.host_curve import sqrt_mod

    jc, tc = _pair(name)
    for p in (jc.host.p, jc.host.order):
        rng = random.Random(p % 997)
        for v in [0, 1, 2, 3, p - 1] + [rng.randrange(p) for _ in range(60)]:
            want, got = tonelli_shanks(v, p), sqrt_mod(v, p)
            assert (got is None) == (want is None) and (got is None or got in (want, (p - want) % p)), v
    rng_t, rng_j = random.Random(9), random.Random(9)
    assert [tc.host.rand_point(rng_t) for _ in range(4)] == [jc.host.rand_point(rng_j) for _ in range(4)]


@pytest.mark.parametrize("p", [7, 103, 13, 97, 257, 65537])
def test_sqrt_mod_every_residue_of_a_small_prime(p):
    """`sqrt_mod` against the squares mod p, for every n < p: a root of n
    when n is a square, else None (p = 3 mod 4 takes the power shortcut,
    p = 1 mod 4 Cipolla's loop, 65537 with 2^16 dividing p - 1)."""
    from mental_poker_tpu_torch.utils.host_curve import sqrt_mod

    squares = {x * x % p for x in range(p)}
    for n in range(p):
        r = sqrt_mod(n, p)
        assert (r is not None) == (n in squares), n
        assert r is None or r * r % p == n, n


@pytest.mark.parametrize("name", CURVES)
def test_decompress_matches_jax_host(name):
    """The port's host `decompress` (through `sqrt_mod`) gives the JAX
    package's points for both sign flags, and None off the curve."""
    jc, tc = _pair(name)
    rng = random.Random(17)
    xs = [tc.host.rand_point(rng)[0] for _ in range(6)] + [rng.randrange(tc.host.p) for _ in range(10)]
    for x in xs:
        for neg in (False, True):
            assert tc.host.decompress(x, neg) == jc.host.decompress(x, neg), (x, neg)
    assert any(tc.host.decompress(x, False) is None for x in xs[6:])
