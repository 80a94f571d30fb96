"""The port's window fold and gather MSM engine against the JAX package and
host bigints, on the CPU (the fold kernel's plain version).

- `fold_windows` on the inputs of `tests/test_pallas_curve.py::
  test_fold_windows_matches_scan` (`GameRng(5)`, W = 5, B = 3, c = 4) equals
  the JAX fold limb for limb (projective X, Y, Z): both run the Horner
  schedule of `_fold_kernel` with the same complete additions.
- `msm(engine="gather")` at one statement of N in {1, 3, 4} points, with the
  scalars 0, 1 and q - 1 and an identity point among the inputs, equals host
  bigints, the port's lane engine and the JAX gather engine as affine points
  (the engines add in different orders, so projective triples differ).
- `msm(engine=None)` takes the gather engine exactly where the JAX rule
  (`mental_poker_tpu/ops/msm.py:113-118`) would.

The JAX values are pinned below; the `slow` test recomputes them live. The
pinned fold is the JAX package's jnp fold (`mental_poker_tpu/ops/msm.py:
207-214`, the same schedule as the Pallas kernel, whose point addition
`tests/test_pallas_curve.py` pins bit-identical to the jnp one): the
interpret-mode kernel itself compiles for over 18 minutes and takes ~20 GB on
an 8-core x86 CPU at these shapes.
Tolerance: exact equality of field integers.
"""

import random

import numpy as np
import pytest
import torch

from mental_poker_tpu.ops import curve as jcurve
from mental_poker_tpu.ops import msm as jmsm
from mental_poker_tpu.ops.curve import PointP as JPointP
from mental_poker_tpu_torch.ops import msm as tmsm
from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
from mental_poker_tpu_torch.ops.curve import PointP, stark_curve
from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs

from _torch_bridge import one_torch_thread  # noqa: F401

W, B, C = 5, 3, 4

# JAX jnp fold of `_fold_inputs()` (mental_poker_tpu/ops/msm.py:207-214 on
# the inputs of test_pallas_curve.py::test_fold_windows_matches_scan):
# canonical (X, Y, Z) per statement.
FOLD_PIN = [
    [
        869100458910941486461934241388937039868431786366438644452563575453013214688,
        1853981057173957680573278270438771874760920889459919663556345241707229846322,
        2184859390383172463904875301029301003249240798503610482293563699437299409457,
    ],
    [
        1896698354387497788432662957558123324332298652662894882088287533966309343962,
        1031742321942027254986317362558998871957454427213318985597415824111852335930,
        3293019381133614484647398170967273148475627705195415598254773266820537960282,
    ],
    [
        615561506151068458878799834389824757532992130379124834797118361831845649917,
        1765758425258072741645411544085343299982772729539856524799890223211419682268,
        1373495657662318963325713683608586952577340419133663745754331156706685615242,
    ],
]

# JAX `msm(cv, P, k, engine="gather")` of `_gather_case(N)`: affine host point.
GATHER_PIN = {
    1: (
        474337791184918587909552897605363713979518776272474721772248457134441556536,
        3193799465641235966152013861575283842903172734738683139709386272715166935155,
        False,
    ),
    3: (
        2608044219748522499342269453757591904504030047335067323713664713754484806126,
        1742690705051322415590912051824798439407662914381960185447086444633463529572,
        False,
    ),
    4: (
        798917215902627271923018633387080779026039916926084525414563261661934924137,
        94732346904235008813416627686059119672511390403901265622647093080639403225,
        False,
    ),
}


def _fold_inputs(cv):
    rng = GameRng(5)
    return [[cv.host.rand_point(rng.rng) for _ in range(B)] for _ in range(W)]


def _gather_case(h, N):
    """N points and scalars from `random.Random(40 + N)`, with the edge
    scalars 0, 1, q - 1 and (N = 4) an identity point with a random scalar."""
    r = random.Random(40 + N)
    q = h.order
    pts = [h.mul(r.randrange(1, q), h.generator) for _ in range(N)]
    ks = [r.randrange(q) for _ in range(N)]
    edges = {1: [q - 1], 3: [0, 1, q - 1], 4: [None, None, 1, q - 1]}[N]
    ks = [k if e is None else e for k, e in zip(ks, edges)]
    if N == 4:
        pts[1] = h.identity
    return pts, ks


def _host_msm(h, pts, ks):
    acc = h.identity
    for p, k in zip(pts, ks):
        acc = h.add(acc, h.mul(k, p))
    return acc


@pytest.fixture(scope="module")
def cv():
    return stark_curve()


def _port_fold(cv, hp):
    S = PointP(*(torch.stack([getattr(cv.from_host_points(row, "cpu"), f) for row in hp]) for f in "xyz"))
    return cuda_curve.fold_windows(cv, S, C)


def test_fold_windows_matches_jax_and_host(cv):
    hp = _fold_inputs(cv)
    out = _port_fold(cv, hp)
    got = [[cv.fq.to_int(co[b]) for co in out] for b in range(B)]
    assert got == FOLD_PIN
    h = cv.host
    want = []
    for b in range(B):
        acc = h.identity
        for w in range(W):
            acc = h.add(acc, h.mul(1 << (C * w), hp[w][b]))
        want.append(acc)
    assert cv.to_host_points(PointP(*out)) == want
    # the lane kernel's plain version folds through the same routine
    assert cuda_msm.fold_windows_plain is cuda_curve.fold_windows_plain


def test_fold_windows_wrapper_checks(cv):
    S = PointP(*(cv.identity((W, 2), "cpu")))
    with pytest.raises(ValueError):
        cuda_curve.fold_windows_cuda(cv, S, C)  # CPU tensors never reach the kernel
    no_statements = cuda_curve.fold_windows(cv, PointP(*(t[:, :0] for t in S)), C)
    assert no_statements[0].shape == (0, cv.fq.L)
    no_windows = cuda_curve.fold_windows(cv, PointP(*(t[:0] for t in S)), C)
    assert bool(cv.is_identity(PointP(*no_windows)).all())


@pytest.mark.parametrize("N", [1, 3, 4])
def test_gather_engine_matches_host_lanes_and_jax(cv, N):
    pts, ks = _gather_case(cv.host, N)
    P = cv.from_host_points(pts, "cpu")
    k = torch.as_tensor(ints_to_limbs(ks, cv.fr.L).astype(np.int32))
    gather = cv.to_host_points(tmsm.msm(cv, P, k, engine="gather"))
    lanes = cv.to_host_points(tmsm.msm(cv, P, k, engine="lanes"))
    assert gather == lanes == [_host_msm(cv.host, pts, ks)] == [GATHER_PIN[N]]


def test_engine_rule(cv, monkeypatch):
    """engine=None takes the gather engine for one statement of fewer than
    16 points, the lane engine otherwise (the engines are stubbed)."""
    seen = []

    def fake(name):
        def run(cv_, P, k, *args):
            seen.append((name, tuple(P[0].shape[:2])))
            ident = cv_.identity_like(P[0][:, 0])
            return ident if name == "gather" else tuple(ident)

        return run

    monkeypatch.setattr(tmsm, "msm_gather", fake("gather"))
    monkeypatch.setattr(cuda_msm, "msm_lanes", fake("lanes"))
    for S, N in [(1, 1), (1, 15), (1, 16), (2, 1), (3, 4)]:
        seen.clear()
        P = cv.identity((S, N), "cpu")
        k = torch.zeros((S, N, cv.fr.L), dtype=torch.int32)
        out = tmsm.msm(cv, P, k)
        assert out.x.shape == (S, cv.fq.L)
        assert seen[0][0] == ("lanes" if tmsm.use_lanes(S, N) else "gather")
        assert tmsm.use_lanes(S, N) == (S >= 2 or N >= 16)
    with pytest.raises(ValueError):
        tmsm.msm(cv, P, k, engine="pippenger")


@pytest.mark.slow
def test_pins_against_live_jax():
    """Recompute every pinned value through the JAX package."""
    import jax
    import jax.numpy as jnp

    jc = jcurve.stark_curve()
    hp = _fold_inputs(jc)
    S = JPointP(*(jnp.stack([q[i] for q in map(jc.from_host_points, hp)], 0) for i in range(3)))

    def body(acc, s):
        acc = jax.lax.fori_loop(0, C, lambda i, a: jc.dbl(a), acc)
        return jc.add(acc, JPointP(*s)), None

    out, _ = jax.lax.scan(body, jc.identity_like(S.x[0]), tuple(jnp.flip(q, axis=0) for q in S))
    assert [[jc.fq.to_int(np.asarray(co)[b]) for co in out] for b in range(B)] == FOLD_PIN
    for N in (1, 3, 4):
        pts, ks = _gather_case(jc.host, N)
        got = jmsm.msm(jc, jc.from_host_points(pts), ints_to_limbs(ks, jc.fr.L), engine="gather")
        assert jc.to_host_points(got) == [GATHER_PIN[N]]
