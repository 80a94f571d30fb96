"""The port's chunked MSM kernel (`ops/cuda/msm.py::msm_chunked`, its plain
version on the CPU) against the JAX package's `_msm_kernel_chunked` and host
bigints.

- Toy curve (`tests/test_pallas_msm_gate.py`'s 21-bit curve: L = 2 limbs,
  W = 6 windows), its `_setup(cv, 3, 5, seed=4)` statement at NC = 4, so
  NB = 2 with 3 pad slots: the window sums equal the JAX kernel's emit-mode
  output, and their fold equals `pmsm.msm_lanes(..., interpret=True, nc=4)`,
  limb for limb (projective X, Y, Z). The JAX values are pinned below: the
  interpret-mode kernel compiles for minutes even on this curve. The `slow`
  test recomputes them through the JAX package.
- Stark, S = 2, N = 5 and 9, NC = 4 and 8: equal to host bigints and to the
  one-point-per-step plain version as affine points, with the scalars 0, 1
  and q - 1 and an identity point among the inputs; and the verifier's
  narrowest combos at nc = 8, N = 1 (NC = 1, no tree) and N = 4 (NC = 4).
- The staged (2, 4) proof made with `msm_nc = 4` equals the `msm_nc = 1`
  proof leaf for leaf.
- The window kernel's walk (`csrc/msm_chunked.cu`: one thread per window,
  each chunk's tree evaluated in post-order on a stack), written out in
  Python over expression trees with the stack depth the kernel's launch
  gives that NC (`stack_depth`: two partial sums up to NC = 8, five up to
  64; one fewer is too few at NC 4, 8, 16 and 64), builds the same expression as the JAX kernel's level-by-level pairing for
  every NC from 1 to 8 and at NC 9, 16, 31, 33, 52 and 64, with and without
  pad slots, in NB * NC additions.
- `msm_lanes` at nc = 16 and nc = 100 (above `CHUNK_MAX`, so NC = N):
  Stark, S = 2, N = 20, equal to host bigints.

Tolerance: exact equality of field integers.
"""

import functools

import numpy as np
import pytest
import torch

from mental_poker_tpu_torch import config, params
from mental_poker_tpu_torch.arguments import device_api
from mental_poker_tpu_torch.crypto import elgamal
from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
from mental_poker_tpu_torch.ops import msm as tmsm
from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
from mental_poker_tpu_torch.ops.curve import Curve, PointP, map_point, stark_curve
from mental_poker_tpu_torch.ops.field import Field
from mental_poker_tpu_torch.utils.host_curve import HostCurve
from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs

from _torch_bridge import leaves, one_torch_thread  # noqa: F401

TOY = HostCurve(name="toy21", p=1048583, a=1, b=104, order=1048601, gx=0, gy=944764)
S_TOY, N_TOY, NC_TOY = 3, 5, 4

# JAX `pmsm.msm_lanes(cv, pts, k, interpret=True, nc=4)` on the toy statement
# (`_msm_kernel_chunked` with its in-kernel fold): canonical (X, Y, Z) per
# statement.
JAX_MSM_PIN = [[955335, 804798, 651412], [53620, 948758, 182319], [1012463, 584910, 835359]]

# JAX `_build_msm_chunked(..., emit=True)` on the same statement (the window
# sums before the fold, windows below W): canonical (X, Y, Z) [w][s].
JAX_WINDOWS_PIN = [
    [[183453, 873987, 173780], [806306, 693786, 42839], [518758, 158705, 666474]],
    [[196730, 696370, 2046], [600416, 780771, 756874], [571797, 1019021, 469046]],
    [[252042, 17396, 436794], [347004, 452637, 104138], [104861, 567472, 872990]],
    [[823118, 951071, 820783], [235010, 33245, 292440], [475718, 996368, 241951]],
    [[382254, 323051, 353392], [534999, 612782, 1029098], [35178, 289903, 605505]],
    [[0, 1, 0], [0, 1, 0], [755350, 947919, 52170]],
]


@functools.cache
def _toy_curve() -> Curve:
    return Curve(TOY, Field(TOY.p, "toy_fq"), Field(TOY.order, "toy_fr"))


def _toy_statement(cv, S, N, seed):
    """`tests/test_pallas_msm_gate.py::_setup`'s host points and scalars (the
    same `GameRng` draws), as port tensors."""
    rng = GameRng(seed)
    q = TOY.order
    host_pts = [[TOY.mul(rng.scalar(q) or 1, TOY.generator) for _ in range(N)] for _ in range(S)]
    ks = [[rng.scalar(q) for _ in range(N)] for _ in range(S)]
    ks[0][0] = 0
    ks[-1][1] = q - 1
    if S >= 3:
        host_pts[2][2] = TOY.identity
    return host_pts, ks, *_tensors(cv, host_pts, ks)


def _tensors(cv, host_pts, ks):
    S, N = len(ks), len(ks[0])
    flat = cv.from_host_points([p for row in host_pts for p in row], "cpu")
    P = PointP(*(t.reshape(S, N, -1) for t in flat))
    return P, torch.as_tensor(ints_to_limbs(ks, cv.fr.L).astype(np.int32))


def _host_msm(h, host_pts, ks):
    out = []
    for prow, krow in zip(host_pts, ks):
        acc = h.identity
        for p, k in zip(prow, krow):
            acc = h.add(acc, h.mul(k, p))
        out.append(acc)
    return out


def _canonical(cv, coords, *index):
    return [cv.fq.to_int(t[index]) for t in coords]


def test_toy_chunked_equals_jax_kernel():
    cv = _toy_curve()
    host_pts, ks, P, k = _toy_statement(cv, S_TOY, N_TOY, seed=4)
    sums = cuda_msm.msm_chunked(cv, P, k, NC_TOY)
    W = cuda_msm.num_windows(cv)
    assert sums[0].shape == (W, S_TOY, cv.fq.L) == (6, 3, 2)
    assert [[_canonical(cv, sums, w, s) for s in range(S_TOY)] for w in range(W)] == JAX_WINDOWS_PIN
    out = cuda_curve.fold_windows(cv, sums, cuda_msm.WINDOW)
    assert [_canonical(cv, out, s) for s in range(S_TOY)] == JAX_MSM_PIN
    assert cv.to_host_points(PointP(*out)) == _host_msm(TOY, host_pts, ks)
    lanes = cuda_msm.msm_lanes(cv, P, k, nc=NC_TOY)  # the entry point: the same fold of the same sums
    assert all(torch.equal(a, b) for a, b in zip(lanes, out))


@pytest.mark.slow
def test_toy_pins_recomputed_through_jax():
    """The pins above, from the JAX package's interpret-mode kernel (minutes
    of XLA:CPU compile per program)."""
    import jax.numpy as jnp

    from mental_poker_tpu.ops import field as jfield
    from mental_poker_tpu.ops.curve import Curve as JCurve
    from mental_poker_tpu.ops.curve import PointP as JPointP
    from mental_poker_tpu.ops.msm import scalar_digits
    from mental_poker_tpu.ops.pallas import msm as pmsm
    from mental_poker_tpu.ops.pallas.curve import _consts_key
    from mental_poker_tpu.utils import host_curve as jhost

    jtoy = jhost.HostCurve(name="toy21", p=TOY.p, a=TOY.a, b=TOY.b, order=TOY.order, gx=TOY.gx, gy=TOY.gy)
    jcv = JCurve(jtoy, jfield.Field(TOY.p, "toy_fq"), jfield.Field(TOY.order, "toy_fr"))
    host_pts, ks, _, _ = _toy_statement(_toy_curve(), S_TOY, N_TOY, seed=4)
    S, N, L, c = S_TOY, N_TOY, jcv.fq.L, 4
    flat = jcv.from_host_points([p for row in host_pts for p in row])
    pts = JPointP(*(t.reshape(S, N, L) for t in flat))
    k = jnp.asarray(ints_to_limbs(ks, jcv.fr.L))
    got = pmsm.msm_lanes(jcv, pts, k, interpret=True, nc=NC_TOY)
    assert [[jcv.fq.to_int(np.asarray(t)[s]) for t in got] for s in range(S)] == JAX_MSM_PIN

    # emit mode, prepared as msm_lanes prepares the nc > 1 call
    W = -(-jcv.fr.bits // c)
    Wp, BT = -(-W // 8) * 8, 128
    NB = -(-N // NC_TOY)
    padn = NB * NC_TOY - N
    dg = jnp.moveaxis(scalar_digits(k, c, jcv.fr.bits), 0, -1)
    dg = jnp.pad(dg, ((0, BT - S), (0, padn), (0, Wp - W))).astype(jnp.uint32)
    prep = lambda q: jnp.pad(jnp.moveaxis(q, 0, -1), ((0, padn), (0, 0), (0, BT - S)))
    run = pmsm._build_msm_chunked(
        L, NB, NC_TOY, W, c, _consts_key(jcv), np.asarray(jcv.fq.one_mont, np.uint32).tobytes(), BT, True, emit=True
    )
    sums = run(*(prep(q) for q in pts), jnp.moveaxis(dg, 0, -1))
    want = [[[jcv.fq.to_int(np.asarray(t)[w, :, s]) for t in sums] for s in range(S)] for w in range(W)]
    assert want == JAX_WINDOWS_PIN


def _stark_statement(cv, S, N, seed):
    rng = np.random.default_rng(seed)
    h = cv.host
    q = h.order
    pts = [[h.mul(int(rng.integers(1, 2**62)), h.generator) for _ in range(N)] for _ in range(S)]
    ks = [[int.from_bytes(rng.bytes(32), "little") % q for _ in range(N)] for _ in range(S)]
    ks[0][0], ks[0][1], ks[-1][-1] = 0, 1, q - 1
    pts[-1][2] = h.identity
    return pts, ks


@functools.cache
def _stark_case(N):
    """S = 2 statements of N points, their host sums and the one-point-per-
    step plain version's sums (computed once for both NC)."""
    cv = stark_curve()
    pts, ks = _stark_statement(cv, 2, N, 10 * N)
    P, k = _tensors(cv, pts, ks)
    host = _host_msm(cv.host, pts, ks)
    assert cv.to_host_points(PointP(*cuda_msm.msm_lanes_plain(cv, P, k))) == host
    return cv, P, k, host


@pytest.mark.parametrize("N", [5, 9])
@pytest.mark.parametrize("nc", [4, 8])
def test_stark_chunked_matches_host_and_lanes(N, nc):
    cv, P, k, host = _stark_case(N)
    assert cv.to_host_points(PointP(*cuda_msm.msm_lanes(cv, P, k, nc=nc))) == host


@pytest.mark.parametrize("N", [1, 4])
def test_stark_chunked_narrow_combos(N):
    """The verifier's narrowest combos at nc = 8, (2, 1) and (2, 4): N = 1
    runs one point a step with no tree (NC = 1), N = 4 one step of NC = 4
    with no pad slot. Four statements, the first points of which carry the
    scalars 0, 1 and q - 1 and an identity point, against host bigints."""
    cv = stark_curve()
    pts, ks = _stark_statement(cv, 4, 3, 7 + N)
    pts = [row[:N] for row in pts]
    ks = [row[:N] for row in ks]
    ks[1][0], ks[2][0] = 1, cv.host.order - 1
    pts[3][0] = cv.host.identity
    P, k = _tensors(cv, pts, ks)
    assert cv.to_host_points(PointP(*cuda_msm.msm_lanes(cv, P, k, nc=8))) == _host_msm(cv.host, pts, ks)


def test_msm_wide_split_at_nc8():
    """`ops.msm.msm` with `msm_nc = 8`: one statement of 21 points splits in
    two parts of 11 (N >= 2 * max(8, 8)), each chunked as 8 + 3 (5 pad
    slots)."""
    cv = stark_curve()
    pts, ks = _stark_statement(cv, 1, 21, 3)
    P, k = _tensors(cv, pts, ks)
    assert tmsm.split_factor(1, 21, 8) == 2
    with config.override(msm_nc=8):
        got = tmsm.msm(cv, map_point(lambda t: t[0], P), k[0], engine="lanes")
    assert cv.to_host_points(PointP(*(t[None] for t in got))) == _host_msm(cv.host, pts, ks)


@pytest.mark.parametrize("nc", [16, 100])
def test_stark_chunked_wide_nc(nc):
    """nc above 8 (the card once refused it) and above `CHUNK_MAX`: S = 2,
    N = 20 (NC = 16: NB = 2 with 12 pad slots; NC = 20 at nc = 100)."""
    cv = stark_curve()
    pts, ks = _stark_statement(cv, 2, 20, 20)
    P, k = _tensors(cv, pts, ks)
    assert cuda_msm.chunk_points(nc, 20) == min(nc, 20)
    assert cv.to_host_points(PointP(*cuda_msm.msm_lanes(cv, P, k, nc=nc))) == _host_msm(cv.host, pts, ks)


def test_chunked_wrapper_checks():
    cv = stark_curve()
    pts, ks = _stark_statement(cv, 2, 3, 1)
    P, k = _tensors(cv, pts, ks)
    with pytest.raises(ValueError):
        cuda_msm.msm_chunked_cuda(cv, P, k, 4)  # CPU tensors never reach the kernel
    empty = cuda_msm.msm_chunked(cv, tuple(t[:, :0] for t in P), k[:, :0], 4)
    assert empty[0].shape == (63, 2, 16)
    assert bool(cv.is_identity(PointP(*empty)).all())
    with pytest.raises(ValueError):
        cuda_msm.msm_chunked(cv, P, k, 0)  # at least one point a step
    assert cuda_msm.chunk_points(cuda_msm.CHUNK_MAX + 1, 1000) == cuda_msm.CHUNK_MAX == 64


def test_staged_proof_same_at_nc4(monkeypatch):
    """The staged (2, 4) B=1 proof with `msm_nc = 4` (its MSMs through the
    chunked plain version) equals the `msm_nc = 1` proof leaf for leaf."""
    m, n = 2, 4
    N = m * n
    g = params.setup(GameRng(99), m, n, c=4, device="cpu")
    cv = g.cv
    q = cv.host.order
    r = GameRng(100)
    ab = torch.as_tensor(r.scalar_limbs(q, (2, 1, N), cv.fr.L).astype(np.int32))
    deck = Ciphertexts(g.enc.gen_table.mul(ab[0]), g.enc.gen_table.mul(ab[1]))
    pi = torch.as_tensor(np.stack([r.permutation(N)]).astype(np.int64))
    rho = torch.as_tensor(r.scalar_limbs(q, (1, N), cv.fr.L).astype(np.int32))
    permuted = Ciphertexts(*(map_point(lambda t: torch.gather(t, 1, pi[..., None].expand(t.shape)), c) for c in deck))
    shuffled = elgamal.cipher_add(cv, permuted, elgamal.encrypt_zero(g.enc, g.agg_table, rho))
    rand = device_api.sample_shuffle_rand(r, m, n, cv.fr.L, q, batch=1, device="cpu")

    calls = []
    plain = cuda_msm.msm_chunked_plain
    monkeypatch.setattr(cuda_msm, "msm_chunked_plain", lambda *a: calls.append(a[-1]) or plain(*a))
    proofs = []
    for nc in (1, 4):
        with config.override(msm_nc=nc):
            proofs.append(leaves(device_api.prove_shuffle(cv, m, n, g.keys, deck, shuffled, pi, rho, rand)))
    assert calls and set(calls) == {4}
    assert len(proofs[0]) == len(proofs[1]) == 56
    for a, b in zip(*proofs):
        assert torch.equal(a, b)


def _stack_depth(NC):
    """`csrc/msm_chunked.cu::stack_depth`: the shared-memory slots for
    partial sums that the launch gives NC, the least k with 2^(k+1) >= NC."""
    k = 0
    while (2 << k) < NC:
        k += 1
    return k


def _kernel_walk(chunks, depth):
    """`msm_chunked_window_kernel`'s loop, statement for statement, over
    expressions: a leaf is a point index (or "O", the identity of a pad slot
    and of the window sum's start) and an addition is the ordered pair
    (left, right). `stack` has `depth` shared-memory slots for partial sums
    (an IndexError if the walk needed more)."""
    NC = len(chunks[0])
    acc = cur = "O"
    adds = 0
    for chunk in chunks:
        nxt = sp = pending = 0
        stack = [None] * depth
        for _ in range(NC):
            paired = False
            if pending > 0:
                pending -= 1
                sp -= 1
                e = stack[sp]
                paired = True
            elif nxt < NC:
                if nxt > 0:
                    stack[sp] = cur
                    sp += 1
                cur = chunk[nxt]
                nxt += 1
                if nxt < NC:
                    e = cur
                    cur = chunk[nxt]
                    nxt += 1
                    pending = (nxt & -nxt).bit_length() - 2  # __ffs(next) - 2
                    paired = True
            if not paired:
                if sp > 0:
                    sp -= 1
                    e = stack[sp]
                else:
                    e = acc
            cur = (e, cur)
            adds += 1
        acc = cur
    return acc, adds


def _level_pairing(chunks):
    """`mental_poker_tpu/ops/pallas/msm.py::_msm_kernel_chunked`'s reduction
    of each chunk (the `while len(sel) > 1` loop: pairs left to right, an
    odd element carried up), then one accumulate into the window sum."""
    acc = "O"
    for sel in chunks:
        sel = list(sel)
        while len(sel) > 1:
            nxt = [(sel[i], sel[i + 1]) for i in range(0, len(sel) - 1, 2)]
            if len(sel) % 2:
                nxt.append(sel[-1])
            sel = nxt
        acc = (acc, sel[0])
    return acc


@pytest.mark.parametrize("pad", [False, True], ids=["N=3NC", "N=2NC-1"])
@pytest.mark.parametrize("nc", [*range(1, 9), 9, 16, 31, 33, 52, cuda_msm.CHUNK_MAX])
def test_kernel_walk_equals_level_pairing(nc, pad):
    N = 2 * nc - 1 if pad else 3 * nc
    NB = -(-N // nc)
    slots = [i if i < N else "O" for i in range(NB * nc)]
    chunks = [slots[j * nc:(j + 1) * nc] for j in range(NB)]
    depth = _stack_depth(nc)
    walked, adds = _kernel_walk(chunks, depth)
    assert walked == _level_pairing(chunks)
    if depth and nc & (nc - 1) == 0:  # a full chunk of 2^(k+1) slots leaves k waiting: none fewer holds it
        with pytest.raises(IndexError):
            _kernel_walk(chunks, depth - 1)
    assert adds == NB * nc
    first = walked
    for _ in range(NB - 1):
        first = first[0]
    assert first[0] == "O"  # the window sum starts at the identity
    if nc == 7:
        assert first[1] == (((0, 1), (2, 3)), ((4, 5), 6))
