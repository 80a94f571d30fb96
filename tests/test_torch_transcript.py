"""The port's device Blake2s/ChaCha20, transcript, byte layouts and
`GameRng` against hashlib, the host transcript, the JAX device transcript
and the JAX `GameRng`, on the CPU.

Inputs are seeded numpy bytes; tolerance: exact equality. The JAX device
transcript's draws are pinned (its XLA compile takes about 30 s); the
`slow` test recomputes them.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mental_poker_tpu.crypto import transcript_jax
from mental_poker_tpu.crypto.transcript import ChaCha20Words as JChaCha
from mental_poker_tpu.crypto.transcript import FiatShamirRng
from mental_poker_tpu.ops.field import stark_fr as jstark_fr
from mental_poker_tpu.utils.rand import GameRng as JGameRng
from mental_poker_tpu_torch.crypto import hash_dev, serialize_dev, transcript_dev
from mental_poker_tpu_torch.crypto.transcript import ChaCha20Words
from mental_poker_tpu_torch.ops.curve import stark_curve
from mental_poker_tpu_torch.ops.field import stark_fr
from mental_poker_tpu_torch.utils.rand import GameRng

from _torch_bridge import one_torch_thread, to_np  # noqa: F401


def test_blake2s_matches_hashlib():
    rng = np.random.default_rng(42)
    for n in [0, 1, 31, 32, 33, 63, 64, 65, 127, 128, 200, 1024]:
        data = rng.integers(0, 256, size=n, dtype=np.uint8)
        got = hash_dev.blake2s_bytes(torch.as_tensor(data))
        assert bytes(got.numpy()) == hashlib.blake2s(data.tobytes()).digest(), n
    batch = rng.integers(0, 256, size=(3, 2, 100), dtype=np.uint8)
    out = hash_dev.blake2s_bytes(torch.as_tensor(batch)).numpy()
    for i in range(3):
        for j in range(2):
            assert bytes(out[i, j]) == hashlib.blake2s(batch[i, j].tobytes()).digest()


def test_chacha20_matches_host_stream():
    key = hashlib.blake2s(b"chacha test key").digest()
    host = ChaCha20Words(key)
    words = [host.next_u32() for _ in range(96)]
    jhost = JChaCha(key)
    assert words == [jhost.next_u32() for _ in range(96)]
    kw = torch.as_tensor(np.frombuffer(key, dtype="<u4").astype(np.int64))
    starts = torch.tensor([0, 5, 8, 16, 23, 40])
    got = hash_dev.chacha20_words(kw.expand(6, 8), starts, 12)
    for i, s in enumerate(starts.tolist()):
        assert got[i].tolist() == words[s : s + 12], s


# SHA-256 of the JAX device transcript's five draws [16, 5, L], keystream
# positions [16] and seed words [16, 8] on `_stream_inputs`, each as
# little-endian u32 (`test_jax_streams_recomputed` recomputes it).
JAX_STREAMS_SHA256 = "189f1cac3bc1b62c0e34a6e2fb5196d0446a77184af82403a89340ebb5a36dcc"
STREAM_LANES = 16


def _stream_inputs():
    return np.random.default_rng(3).integers(0, 256, size=(STREAM_LANES, 64), dtype=np.uint8)


def _sha256(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(np.asarray(a).astype("<u4")).tobytes())
    return h.hexdigest()


def test_sample_field_streams_match_jax_transcript():
    """B independent transcripts with different absorbs: per-lane rejection
    bookkeeping (draw values and keystream positions) equals the JAX one
    (pinned) and the host transcript's."""
    tf = stark_fr()
    datas = _stream_inputs()
    st = transcript_dev.init(b"Shuffle Proof", (STREAM_LANES,), "cpu")
    st = transcript_dev.absorb(st, torch.as_tensor(datas))
    st, v = transcript_dev.sample_fields(st, tf, 5)
    assert _sha256([to_np(v), st.widx.numpy(), st.seed.numpy()]) == JAX_STREAMS_SHA256
    host = FiatShamirRng(b"Shuffle Proof")
    host.absorb(datas[0].tobytes())
    assert [tf.to_int(r) for r in to_np(v[0])] == [host.sample_field(tf.p) for _ in range(5)]


@pytest.mark.slow
def test_jax_streams_recomputed():
    """`JAX_STREAMS_SHA256` from the JAX device transcript (about 30 s of
    XLA compile)."""
    jf = jstark_fr()

    def jrun(d):
        st = transcript_jax.init(b"Shuffle Proof", (STREAM_LANES,))
        st = transcript_jax.absorb(st, d)
        st, v = transcript_jax.sample_fields(st, jf, 5)
        return st, v

    jst, jv = jax.jit(jrun)(jnp.asarray(_stream_inputs()))
    assert _sha256([np.asarray(jv), np.asarray(jst.widx), np.asarray(jst.seed)]) == JAX_STREAMS_SHA256


def test_point_bytes_match_host_layout():
    from mental_poker_tpu.crypto import serialize

    cv = stark_curve()
    rng = GameRng(99)
    pts = [cv.host.rand_point(rng.rng) for _ in range(3)] + [cv.host.identity]
    blob = serialize_dev.points_blob(cv, cv.from_host_points(pts, "cpu"))
    assert bytes(blob.numpy()) == b"".join(serialize.point_to_bytes(p, cv.host) for p in pts)
    limbs = cv.fq.tensor(cv.fq.from_int_array([7, 123456789]), "cpu")
    assert torch.equal(serialize_dev.bytes_to_limbs(serialize_dev.limbs_to_bytes(limbs)), limbs)


@pytest.mark.parametrize("seed", [0, 1234, 2**70 + 5, -3])
def test_game_rng_streams_match_jax(seed):
    q = stark_fr().p
    a, b = GameRng(seed), JGameRng(seed)
    assert [a.scalar(q) for _ in range(5)] == [b.scalar(q) for _ in range(5)]
    np.testing.assert_array_equal(a.permutation(52), b.permutation(52))
    np.testing.assert_array_equal(a.scalar_limbs(q, (3, 4), 16), b.scalar_limbs(q, (3, 4), 16))
    assert a.bytes(9) == b.bytes(9)
    assert a.scalar(q) == b.scalar(q)


# Message lengths at the Blake2s kernel's block edges (a message of 0 bytes
# is one block of zeros; 55 and 63 end inside the first block; 64 fills it),
# the flows' rows (64-byte Merkle pairs, 130-byte card leaves, 422-byte CP
# blobs with the seed) and a long one.
KERNEL_EDGE_LENGTHS = [0, 1, 55, 63, 64, 65, 128, 130, 422, 6760]


def test_blake2s_plain_matches_hashlib_at_kernel_edges():
    """The plain Blake2s, which CPU tensors take and the kernel is held
    against on the card, equals hashlib at the kernel's edge lengths: with
    and without the 32-byte seed suffix, and on a broadcast (stride-0) row."""
    rng = np.random.default_rng(13)
    for n in KERNEL_EDGE_LENGTHS:
        data = rng.integers(0, 256, size=(2, n), dtype=np.uint8)
        suffix = rng.integers(0, 2**32, size=(2, 8), dtype=np.int64)
        tail = [suffix[i].astype("<u4").tobytes() for i in range(2)]
        got = hash_dev.words_to_bytes(hash_dev.blake2s_plain(torch.as_tensor(data))).numpy()
        got_sfx = hash_dev.words_to_bytes(hash_dev.blake2s_plain(torch.as_tensor(data), torch.as_tensor(suffix))).numpy()
        shared = torch.as_tensor(data[:1]).expand(3, n)
        got_shared = hash_dev.words_to_bytes(hash_dev.blake2s_plain(shared, torch.as_tensor(suffix[:1]))).numpy()
        for i in range(2):
            assert bytes(got[i]) == hashlib.blake2s(data[i].tobytes()).digest(), n
            assert bytes(got_sfx[i]) == hashlib.blake2s(data[i].tobytes() + tail[i]).digest(), n
        assert all(bytes(r) == hashlib.blake2s(data[0].tobytes() + tail[0]).digest() for r in got_shared), n


def _host_draw(key: bytes, start: int, p: int, nw: int, hi_mask: int, K: int):
    """The draw on the host stream: (value, found, words consumed)."""
    stream = ChaCha20Words(key)
    words = [stream.next_u32() for _ in range(start + K * nw)][start:]
    for c in range(K):
        w = words[c * nw : (c + 1) * nw]
        w[-1] &= hi_mask
        v = sum(x << (32 * j) for j, x in enumerate(w))
        if v < p:
            return v, True, (c + 1) * nw
    return v, False, K * nw


@pytest.mark.parametrize("fname", ["stark_fr", "bls12_377_fr", "bls12_377_fq"])
def test_draw_on_cpu_is_plain_and_matches_host_stream(fname):
    """CPU tensors take `_draw_plain` and launch nothing; its value, found
    and advance equal the host ChaCha20 stream's at K = 1, 8, 64 from words
    0, 15, 16, 17 and 1,000 (K = 1 leaves some lanes without a candidate:
    the value is then the masked candidate)."""
    from mental_poker_tpu_torch.ops import field as tfield
    from mental_poker_tpu_torch.ops.cuda import LAUNCHES

    fld = getattr(tfield, fname)()
    nw, hi_mask = transcript_dev._uniform_spec(fld)
    rng = np.random.default_rng(17)
    keys = [rng.bytes(32) for _ in range(6)]
    seed = torch.as_tensor(np.stack([np.frombuffer(k, "<u4").astype(np.int64) for k in keys]))
    before = dict(LAUNCHES)
    missed = 0
    for K in (1, 8, 64):
        for start in (0, 15, 16, 17, 1000):
            widx = torch.full((6,), start, dtype=torch.int64)
            val, found, adv = transcript_dev._draw(seed, widx, fld, K)
            want = transcript_dev._draw_plain(seed, widx, fld, K)
            assert all(torch.equal(a, b) for a, b in zip((val, found, adv), want))
            for i, key in enumerate(keys):
                v, ok, n = _host_draw(key, start, fld.p, nw, hi_mask, K)
                assert (sum(int(x) << (16 * j) for j, x in enumerate(val[i])), bool(found[i]), int(adv[i])) == (v, ok, n)
                missed += not ok
    assert missed > 0  # the K = 1 rounds left some lane undone
    assert LAUNCHES == before


def test_cpu_tensors_take_plain_hash_paths():
    """Blake2s, its bytes, absorb and the deck Merkle root on CPU tensors
    run the plain versions (no kernel launch counted) and equal hashlib."""
    from mental_poker_tpu_torch.arguments import staged
    from mental_poker_tpu_torch.ops.cuda import LAUNCHES

    rng = np.random.default_rng(19)
    before = dict(LAUNCHES)
    data = rng.integers(0, 256, size=(3, 130), dtype=np.uint8)
    t = torch.as_tensor(data)
    assert torch.equal(hash_dev.blake2s(t), hash_dev.blake2s_plain(t))
    assert [bytes(r) for r in hash_dev.blake2s_bytes(t).numpy()] == [hashlib.blake2s(r.tobytes()).digest() for r in data]
    st = transcript_dev.init(b"Shuffle Proof", (3,), "cpu")
    st2 = transcript_dev.absorb(st, t)
    host = FiatShamirRng(b"Shuffle Proof")
    host.absorb(data[1].tobytes())
    assert bytes(hash_dev.words_to_bytes(st2.seed[1]).numpy()) == host.seed
    assert st2.widx.tolist() == [0, 0, 0]
    leaves = rng.integers(0, 256, size=(2, 7, 130), dtype=np.uint8)
    for b in range(2):
        level = [hashlib.blake2s(leaf.tobytes()).digest() for leaf in leaves[b]]
        while len(level) > 1:
            level = [hashlib.blake2s(level[i] + level[i + 1]).digest() for i in range(0, len(level) - 1, 2)] + (
                level[-1:] if len(level) % 2 else [])
        assert bytes(staged._tree_root_dev(torch.as_tensor(leaves))[b].numpy()) == level[0]
    assert LAUNCHES == before
