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
