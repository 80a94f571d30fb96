"""The port's game round (`models/round.py`, the flow of the reference's
`examples/round.rs`) against the JAX package, on the CPU.

`play_round(seed=99, m=2, n=2, 3 players, 1 shuffle)` plays the same game
in both packages: setup, card encoding, key ceremony, the masked deck, the
shuffle (the staged prover, its proof through `dev_proof_to_host` and back
through `host_proof_to_dev` into the staged verifier), the deal, private
peeks and the public reveal, every draw from one `GameRng(99)` in the same
order. The opened cards, the shuffled deck and the shuffle proof's bytes
equal the JAX package's; the function itself raises if a peek disagrees
with the open. The round's staged proof, in its host form, also passes the
host `ShuffleArgument` verifier. The JAX values are pinned; the `slow` tests
recompute them live and play the canonical (2, 26), 4-player, 4-shuffle
round in the port. Tolerance: equal cards and bytes.
"""

import contextlib
import hashlib
import types

import pytest

from mental_poker_tpu_torch.crypto import proof_io
from mental_poker_tpu_torch.crypto.serialize import point_to_bytes_compressed
from mental_poker_tpu_torch.crypto.transcript import SHUFFLE_RNG_SEED, TranscriptBatch
from mental_poker_tpu_torch.models.round import ClassicPlayingCard, cipher_keys, play_round
from mental_poker_tpu_torch.protocol import api
from mental_poker_tpu_torch.protocol.dl_cards import DLCards

from _torch_bridge import one_torch_thread  # noqa: F401

ARGS = dict(seed=99, m=2, n=2, player_names=(b"A", b"B", b"C"), num_shuffles=1)

# JAX `mental_poker_tpu.models.round.play_round(**ARGS)`: (value, suite) per player.
ROUND_PIN = {
    'A': ('Two', 'Diamond'),
    'B': ('Two', 'Heart'),
    'C': ('Two', 'Club'),
}
# The same JAX run's shuffled deck (compressed c0, c1 of each card, `cipher_keys`
# order) and SHA-256 of its shuffle proof (`proof_io.shuffle_to_bytes`), as
# recorded at the `verify_shuffle` call.
ROUND_DECK_PIN = (
    "b8fd82e3fcf250b1e6c6992bfecc3c0acce0f30dd23336aaf437747546471783"
    "0ed5e82b6ebd965d86709cc5454cd40a6f61649acceb0516818f7b0d8968b707"
    "f40586e45b98aeb1e6af2326d7e176afb4a87b363a14a162d206340b17a77882"
    "a0e257ae48a14949bededea46bba4a9e05f216c7bc77e179403a2c2fbf962501"
    "789bfacdbc8d1e40da5cdfaf63075da2d6e12d75c84fc77b4de8ee7bc12f7485"
    "637d1ec79cd41d1ca03ef2c92f0b50a7525d5de5929771ffeb96e839abbbab82"
    "7db87028dcdeba78e8ab36b1f51c5d432303a9fe9306b6fb6765744af4b2ff87"
    "f3882029613f2686aa1e85a84dc7719302109db00b0842d073e3da8676823701"
)
ROUND_PROOF_SHA256 = "fb7c654e5167c25fd758bf4f517ece39f977d78521e081a43720cede3c80e528"


@contextlib.contextmanager
def recording_verify_shuffle(cls):
    """Record (proto, pp, agg, deck, shuffled, proof) of every
    `cls.verify_shuffle` call while the block runs."""
    calls = []
    orig = cls.verify_shuffle

    def spy(self, pp, agg, deck, shuffled, proof):
        calls.append(types.SimpleNamespace(proto=self, pp=pp, agg=agg, deck=deck, shuffled=shuffled, proof=proof))
        return orig(self, pp, agg, deck, shuffled, proof)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cls, "verify_shuffle", spy)
        yield calls


def _digest(h, keys, proof_bytes: bytes) -> tuple:
    """(deck hex, proof SHA-256) from a deck's `cipher_keys` and proof bytes."""
    deck = b"".join(point_to_bytes_compressed(c0, h) + point_to_bytes_compressed(c1, h) for c0, c1 in keys)
    return deck.hex(), hashlib.sha256(proof_bytes).hexdigest()


def _cards(opened) -> dict:
    return {k: (v.value, v.suite) for k, v in opened.items()}


@pytest.fixture(scope="module")
def small_round():
    with recording_verify_shuffle(DLCards) as calls:
        opened = play_round(**ARGS, device="cpu")
    (shuffle,) = calls
    return opened, shuffle


def test_small_round_equals_jax(small_round):
    opened, shuffle = small_round
    assert all(isinstance(c, ClassicPlayingCard) for c in opened.values())
    assert _cards(opened) == ROUND_PIN
    h = shuffle.proto.cv.host
    got = _digest(h, cipher_keys(shuffle.proto, shuffle.shuffled), proof_io.shuffle_to_bytes(shuffle.proof, h))
    assert got == (ROUND_DECK_PIN, ROUND_PROOF_SHA256)


def test_host_verifier_accepts_staged_proof(small_round):
    """The round's proof comes from the staged prover through
    `dev_proof_to_host`; the host Bayer-Groth verifier accepts it."""
    s = small_round[1]
    ts = TranscriptBatch.fixed(SHUFFLE_RNG_SEED, 1)
    api.ShuffleArgument().verify((s.pp, s.agg), (s.deck, s.shuffled), s.proof, ts)


@pytest.mark.slow
def test_small_round_live_jax():
    from mental_poker_tpu.crypto import proof_io as jproof_io
    from mental_poker_tpu.models.round import cipher_keys as jcipher_keys
    from mental_poker_tpu.models.round import play_round as jplay_round
    from mental_poker_tpu.protocol.dl_cards import DLCards as JDLCards

    with recording_verify_shuffle(JDLCards) as calls:
        opened = jplay_round(**ARGS)
    (shuffle,) = calls
    h = shuffle.proto.cv.host
    got = _digest(h, jcipher_keys(shuffle.proto, shuffle.shuffled), jproof_io.shuffle_to_bytes(shuffle.proof, h))
    assert _cards(opened) == ROUND_PIN
    assert got == (ROUND_DECK_PIN, ROUND_PROOF_SHA256)


@pytest.mark.slow
def test_canonical_round():
    """The reference's shape: 52 cards, 4 players, 4 verified shuffles."""
    opened = play_round(seed=7, m=2, n=26, num_shuffles=4, device="cpu")
    assert len(opened) == 4
    assert len(set(opened.values())) == 4
