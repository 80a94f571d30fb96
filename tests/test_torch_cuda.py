"""The port's CUDA kernels against their plain PyTorch versions, on the card,
and the fused latency mode (`arguments/fused.py`): B = 1 proofs replayed
from CUDA graphs against the staged flow, and the card's fused and staged
proofs against the CPU's plain path.

Marked `cuda`: each test decides inside a fixture whether a card is present
and skips otherwise. On a machine with a card and nvcc:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Inputs are seeded; tolerance: exact equality of limbs.
"""

import hashlib

import numpy as np
import pytest
import torch

from mental_poker_tpu_torch import config, params
from mental_poker_tpu_torch.arguments import device_api, fused
from mental_poker_tpu_torch.arguments.device import leaves
from mental_poker_tpu_torch.crypto import elgamal, hash_dev, transcript_dev
from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
from mental_poker_tpu_torch.ops import field as tfield
from mental_poker_tpu_torch.ops import cuda as cuda_ops
from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
from mental_poker_tpu_torch.ops.cuda import field as cuda_field
from mental_poker_tpu_torch.ops.cuda import msm as cuda_msm
from mental_poker_tpu_torch.ops.curve import PointP, bls12_377_g1, map_point, stark_curve
from mental_poker_tpu_torch.ops.msm import FixedBaseTable
from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _points(cv, n, seed, dev):
    rng = GameRng(seed)
    return cv.from_host_points([cv.host.rand_point(rng.rng) for _ in range(n)], dev)


@pytest.mark.parametrize("fname", ["stark_fq", "stark_fr", "bls12_377_fq"])
def test_mont_mul_kernel_equals_plain(dev, fname):
    f = getattr(tfield, fname)()
    rng = np.random.default_rng(1)
    vals = [0, 1, f.p - 1] + [int.from_bytes(rng.bytes(48), "little") % f.p for _ in range(997)]
    a = f.tensor(f.from_int_array(vals), dev)
    b = a.flip(0)
    assert torch.equal(cuda_field.mont_mul(f, a, b), cuda_field.mont_mul_plain(f, a, b))


def test_point_add_kernel_equals_plain(dev):
    cv = stark_curve()
    P = _points(cv, 64, 2, dev)
    Q = PointP(*(t.flip(0) for t in P))
    got = cuda_curve.point_add(cv, P, Q)
    want = cuda_curve.point_add_plain(cv, P, Q)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _limbs_int(v):
    return sum(int(x) << (16 * j) for j, x in enumerate(v))


# Statement counts at the lane groups' edges: the fold kernel takes four
# statements a block, the MSM kernel two; 1,000 fills many blocks.
EDGE_S = [1, 2, 3, 4, 5, 31, 32, 33, 1000]


@pytest.mark.parametrize("curve", [stark_curve, bls12_377_g1])
@pytest.mark.parametrize("S", EDGE_S)
def test_fold_windows_kernel_edges(dev, curve, S):
    """Window sums k[w, s] * B of one base B (statement 0's top window the
    identity): kernel equal to plain limb for limb, and the first and last
    statements equal to (sum_w 2^(4w) k[w, s]) * B in host ints."""
    cv = curve()
    W, c, q = cuda_curve.FOLD_W[cv.fq.L], cuda_curve.FOLD_WINDOW, cv.host.order
    base = cv.host.rand_point(GameRng(8).rng)
    kh = GameRng(W + S).scalar_limbs(q, (W, S), cv.fr.L).astype(np.int32)
    kh[W - 1, 0] = 0
    sums = FixedBaseTable(cv, base, c, dev).mul(torch.as_tensor(kh, device=dev))
    got = cuda_curve.fold_windows(cv, sums, c)
    want = cuda_curve.fold_windows_plain(cv, sums, c)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    host = cv.to_host_points(PointP(*(t[[0, S - 1]] for t in got)))
    for h, s in zip(host, (0, S - 1)):
        total = sum(_limbs_int(kh[w, s]) << (c * w) for w in range(W))
        assert h == cv.host.mul(total % q, base)


@pytest.mark.parametrize("curve", [stark_curve, bls12_377_g1])
@pytest.mark.parametrize("S,N", [(1, 1)] + [(S, 3) for S in EDGE_S if S != 4 and S != 5])
def test_msm_kernel_edges(dev, curve, S, N):
    """Points a[s, i] * B of one base B: kernel equal to plain limb for limb,
    and the first and last statements equal to (sum_i k a) * B."""
    cv = curve()
    q = cv.host.order
    base = cv.host.rand_point(GameRng(9).rng)
    a = GameRng(S + 10 * N).scalar_limbs(q, (S, N), cv.fr.L).astype(np.int32)
    k = GameRng(S + 10 * N + 1).scalar_limbs(q, (S, N), cv.fr.L).astype(np.int32)
    P = FixedBaseTable(cv, base, 4, dev).mul(torch.as_tensor(a, device=dev))
    kt = torch.as_tensor(k, device=dev)
    got = cuda_msm.msm_lanes(cv, P, kt, nc=1)
    want = cuda_msm.msm_lanes_plain(cv, P, kt)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    host = cv.to_host_points(PointP(*(t[[0, S - 1]] for t in got)))
    for h, s in zip(host, (0, S - 1)):
        total = sum(_limbs_int(a[s, i]) * _limbs_int(k[s, i]) for i in range(N))
        assert h == cv.host.mul(total % q, base)


def test_msm_kernel_equals_plain(dev):
    cv = stark_curve()
    P = PointP(*(t.reshape(4, 8, -1) for t in _points(cv, 32, 3, dev)))
    k = torch.as_tensor(GameRng(4).scalar_limbs(cv.host.order, (4, 8), 16).astype(np.int32), device=dev)
    got = cuda_msm.msm_lanes(cv, P, k)
    want = cuda_msm.msm_lanes_plain(cv, P, k)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("curve", [stark_curve, bls12_377_g1])
def test_fold_windows_kernel_equals_plain(dev, curve):
    cv = curve()
    W = cuda_curve.FOLD_W[cv.fq.L]
    S = PointP(*(t.reshape(W, 3, -1) for t in _points(cv, 3 * W, 5, dev)))
    got = cuda_curve.fold_windows(cv, S, cuda_curve.FOLD_WINDOW)
    want = cuda_curve.fold_windows_plain(cv, S, cuda_curve.FOLD_WINDOW)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        cuda_curve.fold_windows(cv, PointP(*(t[:5] for t in S)), cuda_curve.FOLD_WINDOW)  # W not built in


@pytest.mark.parametrize("curve,S,N,nc", [(stark_curve, 64, 52, 8), (stark_curve, 3, 5, 4), (bls12_377_g1, 16, 10, 8),
                                          (stark_curve, 1, 5, 3), (bls12_377_g1, 33, 5, 3),
                                          (stark_curve, 3, 40, 16), (bls12_377_g1, 3, 40, 16),
                                          (stark_curve, 33, 60, 52), (bls12_377_g1, 33, 60, 52),
                                          (stark_curve, 2, 130, 64), (bls12_377_g1, 1, 100, 64)])
def test_msm_chunked_kernel_equals_plain(dev, curve, S, N, nc):
    """The window sums, limb for limb, with N % NC != 0 (pad slots), the
    scalars 0, 1 and q - 1 and an identity point among the inputs (the
    last two in statement 1 where there is one). S = 1 and S = 33 leave the
    last block of two statements half empty. NC 16, 52 and 64 take a
    deeper stack of partial sums (three, five and five)."""
    cv = curve()
    P = PointP(*(t.reshape(S, N, -1).clone() for t in _points(cv, S * N, 6, dev)))
    q = cv.host.order
    k = torch.as_tensor(GameRng(7).scalar_limbs(q, (S, N), cv.fr.L).astype(np.int32), device=dev)
    k[0, 0] = 0
    k[0, 1] = cv.fr.small_int_limbs(1, dev)
    k[min(1, S - 1), 2] = torch.as_tensor(ints_to_limbs([q - 1], cv.fr.L)[0].astype(np.int32), device=dev)
    for t, v in zip(P, cv.identity((), dev)):
        t[min(1, S - 1), 0] = v
    got = cuda_msm.msm_chunked(cv, P, k, nc)
    want = cuda_msm.msm_chunked_plain(cv, P, k, nc)
    assert got[0].shape == (cuda_msm.num_windows(cv), S, cv.fq.L)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        cuda_msm.msm_chunked(cv, P, k, 0)  # at least one point a step
    if N > cuda_msm.CHUNK_MAX:  # above the kernel's maximum both versions run CHUNK_MAX points a step
        got = cuda_msm.msm_chunked(cv, P, k, N)
        assert all(torch.equal(g, w) for g, w in zip(got, cuda_msm.msm_chunked_plain(cv, P, k, cuda_msm.CHUNK_MAX)))


def _shuffle_statement(dev, g, seed, B=1):
    """B decks of `g`'s shape (random cards c0 = a G, c1 = b G), their
    permutations, remask factors, shuffled decks and prover randomness."""
    cv, N = g.cv, g.m * g.n
    q, L = cv.host.order, cv.fr.L
    r = GameRng(seed)
    ab = torch.as_tensor(r.scalar_limbs(q, (2, B, N), L).astype(np.int32), device=dev)
    deck = Ciphertexts(g.enc.gen_table.mul(ab[0]), g.enc.gen_table.mul(ab[1]))
    pi = torch.as_tensor(np.stack([r.permutation(N) for _ in range(B)]).astype(np.int64), device=dev)
    rho = torch.as_tensor(r.scalar_limbs(q, (B, N), L).astype(np.int32), device=dev)
    permuted = Ciphertexts(*(map_point(lambda t: torch.gather(t, 1, pi[..., None].expand(t.shape)), c) for c in deck))
    shuffled = elgamal.cipher_add(cv, permuted, elgamal.encrypt_zero(g.enc, g.agg_table, rho))
    rand = device_api.sample_shuffle_rand(r, g.m, g.n, L, q, batch=B, device=dev)
    return deck, shuffled, pi, rho, rand


def _fused_and_staged(g, stmt):
    """The statement's proof and flags through the fused flow (a CUDA graph,
    `fuse_b_max` = 1) and through the staged flow."""
    out = []
    for fuse_b_max in (1, 0):
        with config.override(fuse_b_max=fuse_b_max, msm_nc=1):
            proof = device_api.prove_shuffle(g.cv, g.m, g.n, g.keys, *stmt)
            checks = device_api.verify_shuffle(g.cv, g.m, g.n, g.keys, *stmt[:2], proof)
        out.append((proof, checks))
    return out


def _leaves_equal(a, b) -> bool:
    return len(leaves(a)) == len(leaves(b)) and all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def test_fused_b1_equals_staged(dev):
    """(2, 4), B = 1: the proof replayed from the captured graph equals the
    staged proof leaf for leaf, and both flows accept it."""
    g = params.setup(GameRng(31), 2, 4, c=4, device=dev)
    (fproof, fchecks), (sproof, schecks) = _fused_and_staged(g, _shuffle_statement(dev, g, 32))
    assert _leaves_equal(fproof, sproof)
    assert all(bool(c.all()) for c in (*fchecks, *schecks))
    assert any(key[:4] == ("fused_prove", g.cv.name, 2, 4) for key in fused.GRAPHS)


def test_fused_second_statement_keeps_first_proof(dev):
    """A second game (another aggregate key and deck) through the same
    graphs gets its own proof, the staged one, and the first call's proof
    is unchanged by it."""
    g1 = params.setup(GameRng(41), 2, 4, c=4, device=dev)
    g2 = params.setup(GameRng(43), 2, 4, c=4, device=dev)
    (first, _), (first_staged, _) = _fused_and_staged(g1, _shuffle_statement(dev, g1, 42))
    kept = [t.clone() for t in leaves(first)]
    (second, checks), (second_staged, _) = _fused_and_staged(g2, _shuffle_statement(dev, g2, 44))
    assert _leaves_equal(second, second_staged) and not _leaves_equal(second, first)
    assert all(bool(c.all()) for c in checks)
    assert all(torch.equal(a, b) for a, b in zip(leaves(first), kept))
    assert _leaves_equal(first, first_staged)


def _proof_bytes(proof) -> bytes:
    return b"".join(t.cpu().contiguous().numpy().tobytes() for t in leaves(proof))


@pytest.mark.parametrize("B", [1, 3])
def test_card_proofs_equal_cpu_plain_proof(dev, B):
    """(2, 4) at B = 1 and 3: the fused proof (a CUDA graph, the hash
    kernels captured in it) and the staged proof on the card are byte for
    byte the CPU plain path's proof of the same inputs and randomness, and
    the card's verifier accepts both."""
    cpu = torch.device("cpu")
    gc = params.setup(GameRng(51), 2, 4, c=4, device=cpu)
    want = _proof_bytes(device_api.prove_shuffle(gc.cv, 2, 4, gc.keys, *_shuffle_statement(cpu, gc, 52, B)))
    g = params.setup(GameRng(51), 2, 4, c=4, device=dev)
    stmt = _shuffle_statement(dev, g, 52, B)
    cuda_ops.reset_launches()
    for fuse_b_max in (B, 0):
        with config.override(fuse_b_max=fuse_b_max, msm_nc=1):
            proof = device_api.prove_shuffle(g.cv, 2, 4, g.keys, *stmt)
            checks = device_api.verify_shuffle(g.cv, 2, 4, g.keys, *stmt[:2], proof)
        assert _proof_bytes(proof) == want, fuse_b_max
        assert all(bool(c.all()) for c in checks), fuse_b_max
    assert cuda_ops.LAUNCHES["blake2s"] > 0 and cuda_ops.LAUNCHES["chacha_draw"] > 0


# Message lengths at the Blake2s kernel's block edges and the flows' rows
# (64-byte Merkle pairs, 130-byte card leaves, 422-byte CP blobs with the
# seed), and one long message.
B2S_LENGTHS = [0, 1, 55, 63, 64, 65, 128, 130, 422, 6760]


@pytest.mark.parametrize("lanes", [1, 3, 1025])
def test_blake2s_kernel_equals_plain_and_hashlib(dev, lanes):
    """The kernel's digest words and bytes equal the plain version's (the
    CPU path) and hashlib's, with and without the seed suffix, on distinct
    and on broadcast (stride-0) rows and suffixes."""
    rng = np.random.default_rng(lanes)
    for n in B2S_LENGTHS:
        data = torch.as_tensor(rng.integers(0, 256, size=(lanes, n), dtype=np.uint8))
        suffix = torch.as_tensor(rng.integers(0, 2**32, size=(lanes, 8), dtype=np.int64))
        for rows in (data, data[:1].expand(lanes, n)):
            for sfx in (None, suffix, suffix[:1].expand(lanes, 8)):
                want = hash_dev.blake2s(rows, sfx)  # CPU tensors: the plain version
                on_card = (rows.to(dev), None if sfx is None else sfx.to(dev))
                got = hash_dev.blake2s(*on_card)
                assert torch.equal(got.cpu(), want), (n, sfx is None)
                if sfx is None:
                    got_b = hash_dev.blake2s_bytes(on_card[0]).cpu().numpy()
                    assert bytes(got_b[-1]) == hashlib.blake2s(rows[-1].numpy().tobytes()).digest(), n
                    assert np.array_equal(got_b, hash_dev.words_to_bytes(want).numpy()), n


def _draw_both(dev, fld, seed, widx, K):
    got = transcript_dev._draw(seed.to(dev), widx.to(dev), fld, K)
    want = transcript_dev._draw(seed, widx, fld, K)  # CPU tensors: the plain version
    return [t.cpu() for t in got], want


@pytest.mark.parametrize("fname", ["stark_fr", "bls12_377_fr", "bls12_377_fq"])
def test_chacha_draw_kernel_equals_plain(dev, fname):
    """Value, found and advance bit for bit at K = 8 and 64 from keystream
    words 0, 15, 16, 17 and 1,000 (nw = 8, 8, 12), on distinct keys and on
    one broadcast key."""
    fld = getattr(tfield, fname)()
    rng = np.random.default_rng(7)
    seed = torch.as_tensor(rng.integers(0, 2**32, size=(257, 8), dtype=np.int64))
    before = cuda_ops.LAUNCHES["chacha_draw"]
    for K in (8, 64):
        for start in (0, 15, 16, 17, 1000):
            widx = torch.as_tensor(start + rng.integers(0, 3, size=257))
            for keys in (seed, seed[:1].expand(257, 8)):
                got, want = _draw_both(dev, fld, keys, widx, K)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), (K, start)
    assert cuda_ops.LAUNCHES["chacha_draw"] == before + 20


def test_chacha_draw_kernel_lanes_without_accept(dev):
    """K = 1 over 4,096 lanes: about half the Stark Fr lanes accept no
    candidate; their value (the masked candidate), found and advance equal
    the plain version's."""
    fld = tfield.stark_fr()
    rng = np.random.default_rng(11)
    seed = torch.as_tensor(rng.integers(0, 2**32, size=(4096, 8), dtype=np.int64))
    widx = torch.as_tensor(rng.integers(0, 2000, size=4096))
    got, want = _draw_both(dev, fld, seed, widx, 1)
    assert 0 < int((~want[1]).sum()) < 4096
    assert all(torch.equal(a, b) for a, b in zip(got, want))
