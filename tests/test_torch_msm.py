"""The port's MSM engines and its MSM-kernel wrapper against the JAX `msm`
(gather engine, the path the JAX tests run on the CPU) and host bigints, on
the CPU (the wrapper's plain version).

Scalars come from seeded `random.Random` draws plus the edges 0, 1 and
q-1; identity points are mixed in. Tolerance: exact equality of affine
values (the engines add in different orders, so projective triples differ).
The JAX gather engine's sums are pinned as the SHA-256 of their affine
values (`JAX_MSM_SHA256`); the `slow` test recomputes them (its trace takes
most of a minute on a cold compile cache).
"""

import hashlib
import random

import numpy as np
import pytest
import torch

from mental_poker_tpu.ops import curve as jcurve
from mental_poker_tpu.ops import msm as jmsm
from mental_poker_tpu.ops.curve import PointP as JPointP
from mental_poker_tpu.utils.rand import ints_to_limbs
from mental_poker_tpu_torch.ops import curve as tcurve
from mental_poker_tpu_torch.ops import msm as tmsm
from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
from mental_poker_tpu_torch.ops.curve import PointP

from _torch_bridge import one_torch_thread, to_torch  # noqa: F401


@pytest.fixture(scope="module")
def curves():
    return jcurve.stark_curve(), tcurve.stark_curve()


def _statement(cv, S, N, seed):
    rng = random.Random(seed)
    h = cv.host
    q = h.order
    pts = [[h.mul(rng.randrange(1, q), h.generator) for _ in range(N)] for _ in range(S)]
    ks = [[rng.randrange(q) for _ in range(N)] for _ in range(S)]
    pts[0][0] = h.identity
    ks[0][1 % N] = 0
    ks[-1][0] = 1
    ks[-1][-1] = q - 1
    return pts, ks


def _host_msm(h, pts, ks):
    out = []
    for prow, krow in zip(pts, ks):
        acc = h.identity
        for p, k in zip(prow, krow):
            acc = h.add(acc, h.mul(k, p))
        out.append(acc)
    return out


# SHA-256 of the JAX `msm(..., engine="gather")` sums of `_statement(S, N)`
# as affine points (`_points_sha256`), by (S, N).
JAX_MSM_SHA256 = {
    (3, 5): "5ad6adc96f028cca2943dd64cd055e72c9a91e9c6401b4369db604155292584e",
    (2, 21): "76204e67eed0ad7b1a36796edd8e3e2c425d005e826a948d70b357e74c8ec5be",
}


def _points_sha256(points) -> str:
    h = hashlib.sha256()
    for x, y, inf in points:
        h.update((x or 0).to_bytes(32, "little") + (y or 0).to_bytes(32, "little") + bytes([inf]))
    return h.hexdigest()


def _inputs(jc, S, N):
    """`_statement(S, N)` as JAX points [S, N], their port copy and the limbs."""
    pts, ks = _statement(jc, S, N, S * 100 + N)
    flat = [p for row in pts for p in row]
    JP = JPointP(*(c.reshape(S, N, -1) for c in jc.from_host_points(flat)))
    TP = PointP(*(to_torch(np.asarray(c)) for c in JP))
    return pts, ks, JP, TP, ints_to_limbs(ks, jc.fr.L)


@pytest.mark.parametrize("S,N", [(3, 5), (2, 21)])
def test_msm_matches_jax_and_host(curves, S, N):
    """(2, 21) takes the wide-split mapping (2 parts of 11, one padded)."""
    jc, tc = curves
    pts, ks, _, TP, k = _inputs(jc, S, N)
    got = tc.to_host_points(tmsm.msm(tc, TP, to_torch(k)))
    assert got == _host_msm(jc.host, pts, ks)
    assert _points_sha256(got) == JAX_MSM_SHA256[(S, N)]


@pytest.mark.slow
@pytest.mark.parametrize("S,N", [(3, 5), (2, 21)])
def test_jax_msm_recomputes_pins(curves, S, N):
    jc, _ = curves
    pts, ks, JP, _, k = _inputs(jc, S, N)
    want = jc.to_host_points(jmsm.msm(jc, JP, k, engine="gather"))
    assert want == _host_msm(jc.host, pts, ks)
    assert _points_sha256(want) == JAX_MSM_SHA256[(S, N)]


def test_msm_lanes_plain_schedule(curves):
    """The kernel's plain version directly, S statements x N points."""
    jc, tc = curves
    pts, ks = _statement(jc, 2, 3, 7)
    flat = [p for row in pts for p in row]
    TP = PointP(*(c.reshape(2, 3, -1) for c in tc.from_host_points(flat, "cpu")))
    k = to_torch(ints_to_limbs(ks, jc.fr.L))
    out = cuda_msm.msm_lanes(tc, TP, k)
    assert tc.to_host_points(PointP(*out)) == _host_msm(jc.host, pts, ks)
    empty = cuda_msm.msm_lanes(tc, tuple(c[:, :0] for c in TP), k[:, :0])
    assert bool(tc.is_identity(PointP(*empty)).all())
    with pytest.raises(ValueError):
        cuda_msm.msm_lanes_cuda(tc, TP, k)


def test_fixed_base_engines_match_host(curves):
    jc, tc = curves
    h = jc.host
    q = h.order
    rng = random.Random(11)
    bases = [h.mul(rng.randrange(1, q), h.generator) for _ in range(3)]
    c = 4
    multi = tmsm.FixedBaseMSM(tc, bases, c, "cpu")
    assert multi.table.x.shape == (3, 63, 16, 16)
    for i, w, d in [(0, 0, 1), (2, 62, 15), (1, 30, 7)]:  # entry = d * 2^(c w) * base
        got = tc.to_host_points(PointP(*(t[i, w, d][None] for t in multi.table)))
        assert got == [h.mul(d << (c * w), bases[i])]
    ks = [0, 1, q - 1, rng.randrange(q), rng.randrange(q), rng.randrange(q)]
    k = ints_to_limbs(ks, jc.fr.L)
    single = tmsm.FixedBaseTable(tc, bases[0], c, table=PointP(*(t[0] for t in multi.table)))
    assert tc.to_host_points(single.mul(to_torch(k))) == [h.mul(kk, bases[0]) for kk in ks]
    got = tc.to_host_points(multi.msm(to_torch(k.reshape(2, 3, -1))))
    assert got == _host_msm(h, [bases, bases], [ks[:3], ks[3:]])
    assert torch.equal(
        tmsm.scalar_digits(to_torch(k), c, jc.fr.bits),
        to_torch(np.asarray(jmsm.scalar_digits(k, c, jc.fr.bits))),
    )
