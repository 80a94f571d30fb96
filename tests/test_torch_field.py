"""The port's `Field` and its Montgomery-multiply wrapper against the JAX
`Field` and host ints, on the CPU (the wrapper's plain version).

Inputs are random reduced elements from a seeded `random.Random`, plus 0, 1
and p-1. Tolerance: exact equality of limbs (integer arithmetic).
"""

import random

import numpy as np
import pytest
import torch

from mental_poker_tpu.ops import field as jfield
from mental_poker_tpu.ops.pallas import field as pfield
from mental_poker_tpu_torch.ops import field as tfield
from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
from mental_poker_tpu_torch.ops.cuda import field as cuda_field
from mental_poker_tpu_torch.utils.rand import int_to_limbs

from _torch_bridge import dense_below_p, one_torch_thread, to_np, to_torch  # noqa: F401

FIELDS = ["stark_fq", "stark_fr", "bls12_377_fq"]


def _elems(f, n, seed):
    rng = random.Random(seed)
    vals = [0, 1, f.p - 1] + [rng.randrange(f.p) for _ in range(n - 3)]
    return np.stack([f.from_int(v) for v in vals]), vals


@pytest.mark.parametrize("fname", FIELDS)
def test_mont_mul_matches_jax_and_bigints(fname):
    jf, tf = getattr(jfield, fname)(), getattr(tfield, fname)()
    a, av = _elems(jf, 40, 1)
    b, bv = _elems(jf, 40, 2)
    b, bv = b[::-1].copy(), bv[::-1]
    got = to_np(tf.mont_mul(to_torch(a), to_torch(b)))
    np.testing.assert_array_equal(got, np.asarray(jf.mont_mul(a, b)))
    np.testing.assert_array_equal(got, np.asarray(pfield.mont_mul(jf, a, b, interpret=True)))
    assert [tf.to_int(r) for r in got] == [x * y % jf.p for x, y in zip(av, bv)]


def test_mont_mul_broadcasts_and_refuses_cpu_kernel_launch():
    tf = tfield.stark_fq()
    a = to_torch(_elems(tf, 6, 3)[0]).reshape(2, 3, tf.L)
    b = to_torch(_elems(tf, 3, 4)[0])[None]
    got = tf.mont_mul(a, b)
    assert got.shape == (2, 3, tf.L) and got.dtype == torch.int32
    want = cuda_field.mont_mul_plain(tf, a, b.expand_as(a))
    assert torch.equal(got, want)
    with pytest.raises(ValueError):
        cuda_field.mont_mul_cuda(tf, a, b.expand_as(a).contiguous())


@pytest.mark.parametrize("fname", ["stark_fq", "bls12_377_fq"])
def test_mont_mul_plain_exact_at_operand_bounds(fname):
    """The plain product on the largest operands the plain point addition
    gives it, against host ints: reduced p - 1 and a dense value below p,
    sums u + v (below 2p, limbs to 2^17) and 3u + v (below 4p), and
    u - v + 4p through `_lazy_offset` (below 5p, limbs to 2^19). Every pair,
    so products reach 25 p^2, the bound the plain version is exact to."""
    tf = getattr(tfield, fname)()
    p, L = tf.p, tf.L
    off = cuda_curve._lazy_offset(p, L, torch.device("cpu")).to(torch.int64)
    lim = lambda v: torch.as_tensor(int_to_limbs(v, L).astype(np.int64))
    value = lambda t: sum(int(x) << (16 * i) for i, x in enumerate(t.tolist()))
    c1, c2 = lim(p - 1), lim(dense_below_p(p, L))
    s1, s2 = c1 + c1, c2 + c2
    ops = [c1, c2, s2, 3 * c2 + c2, c1 + off, c2 + off, off - s2, c2 - s1 + off, c1 - s2 + off, c2 - s2 + off]
    A = torch.stack(ops)
    assert int(A.min()) >= 0 and int(A.max()) < 1 << 19
    vals = [value(t) for t in ops]
    assert max(vals) < 5 * p
    Ri = pow(1 << (16 * L), -1, p)
    n = len(ops)
    got = cuda_field.mont_mul_plain(tf, A.repeat_interleave(n, 0).to(torch.int32), A.repeat(n, 1).to(torch.int32))
    assert [value(r) for r in got] == [u * v * Ri % p for u in vals for v in vals]


OPS = ["add", "sub", "neg", "sqr", "to_mont", "from_mont", "inv", "eq", "canonical_lt"]


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("fname", ["stark_fr", "bls12_377_fq"])
def test_elementwise_ops_match_jax(fname, op):
    jf, tf = getattr(jfield, fname)(), getattr(tfield, fname)()
    a, _ = _elems(jf, 8, 5)
    b, _ = _elems(jf, 8, 6)
    b[4] = a[4]  # one equal pair for eq / canonical_lt
    fn = getattr(jf, op)
    args = (a,) if op in ("neg", "sqr", "to_mont", "from_mont", "inv") else (a, b)
    want = np.asarray(fn(*args))
    got = to_np(getattr(tf, op)(*(to_torch(x) for x in args)))
    np.testing.assert_array_equal(got, want)


def test_vector_algebra_matches_jax():
    jf, tf = jfield.stark_fr(), tfield.stark_fr()
    a, _ = _elems(jf, 15, 7)
    a = a.reshape(3, 5, jf.L)
    b = _elems(jf, 15, 8)[0].reshape(3, 5, jf.L)
    ta, tb = to_torch(a), to_torch(b)
    np.testing.assert_array_equal(to_np(tf.sum_mod(ta, axis=1)), np.asarray(jf.sum_mod(a, axis=1)))
    np.testing.assert_array_equal(to_np(tf.prod_mod(ta, axis=1)), np.asarray(jf.prod_mod(a, axis=1)))
    np.testing.assert_array_equal(to_np(tf.dot_mod(ta, tb, axis=1)), np.asarray(jf.dot_mod(a, b, axis=1)))
    x = a[:, 0]
    for k, start in [(7, 1), (5, 0), (4, 3)]:
        got = to_np(tf.powers(to_torch(x), k, start=start))
        np.testing.assert_array_equal(got, np.asarray(jf.powers(x, k, start=start)))
    np.testing.assert_array_equal(to_np(tf.batch_inv(ta)), np.asarray(jf.batch_inv(a)))
    pre = to_np(tf.prefix_prod(ta, axis=1))
    for j in range(5):
        np.testing.assert_array_equal(pre[:, j], np.asarray(jf.prod_mod(a[:, : j + 1], axis=1)))
    cond = np.array([True, False, True])
    np.testing.assert_array_equal(
        to_np(tf.select(torch.as_tensor(cond), ta[:, 0], tb[:, 0])), np.asarray(jf.select(cond, a[:, 0], b[:, 0]))
    )
    np.testing.assert_array_equal(
        to_np(tf.small_int_limbs(np.arange(1, 9), "cpu")), jf.small_int_limbs(np.arange(1, 9))
    )
