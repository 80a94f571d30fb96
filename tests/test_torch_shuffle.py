"""The port's batched shuffle prove/verify against the JAX package, on the CPU.

The statement is `tests/test_determinism.py`'s (`GameRng(1234)`, (m, n) =
(2, 4)), made by the port's `DLCards` with the JAX package's draws; the
JAX package's statement has the pinned SHA-256 below. Both packages get the
same randomness (`sample_shuffle_rand` from one seed, compared live); the
JAX package's proofs of the statement's deck and of two decks made by the
port are pinned as the SHA-256 of their 56 proof leaves. Tolerance: every
leaf equal, exactly.

Tier 1 holds the port against the pins: the B=1 proof and each deck's slice
of a B=3 proof. One port verify at B=2 accepts the JAX-equal proof and
rejects a tampered deck with "Hadamard Product (5.1)". The `slow` test
traces the JAX prover and verifier (about three minutes), recomputes the
pins, and has the JAX verifier accept the port's proof.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch

from mental_poker_tpu.arguments import device_api as jdevice_api
from mental_poker_tpu.protocol.dl_cards import DLCards as JDLCards
from mental_poker_tpu.utils.rand import GameRng as JGameRng
from mental_poker_tpu_torch import params
from mental_poker_tpu_torch.arguments import device_api
from mental_poker_tpu_torch.crypto import elgamal
from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
from mental_poker_tpu_torch.crypto.errors import HADAMARD, ProofVerificationError
from mental_poker_tpu_torch.ops.curve import map_point, stark_curve
from mental_poker_tpu_torch.ops.msm import FixedBaseTable
from mental_poker_tpu_torch.protocol.dl_cards import DLCards
from mental_poker_tpu_torch.utils.rand import GameRng

from _torch_bridge import leaves, one_torch_thread, rebuild, to_jax_tree, to_np, to_torch  # noqa: F401

M, N_COLS = 2, 4
N = M * N_COLS

# SHA-256 of the JAX statement's deck and shuffled deck as affine points
# (c0 then c1 of each; x, y as 32 little-endian bytes, then the identity
# flag). The two packages' projective coordinates differ; their proofs do
# not.
STATEMENT_SHA256 = "392ff52e225e8ce46dc91265b017166f62c2b7c61ab7498d855ff70f8a7ac811"
# SHA-256 of the 56 leaves of the JAX B=1 proof of each of the three decks
# (the statement's, then the port's decks of seeds 21 and 22).
PROOF_SHA256 = [
    "759fc6b8feb513660bd24375a66b7cc5b591f24d62e55c46e314a52dc77cc853",
    "4a0bb992624c6051167d09be59a460c13a1fbea5bf86125b452fca6e39aad9d4",
    "3fd5b08acecc167772278c5f350831970136bd588b7f980b23cd2b74d3931529",
]


def sha256(arrays) -> str:
    h = hashlib.sha256()
    for t in arrays:
        a = to_np(t) if isinstance(t, torch.Tensor) else np.asarray(t)
        h.update(np.ascontiguousarray(a.astype(bool) if a.dtype == bool else a.astype("<u4")).tobytes())
    return h.hexdigest()


@functools.cache
def _port_statement():
    """`tests/test_determinism.py::_setup` in the port: parameters, the
    aggregate key, a deck and its permute+remask (4-bit tables, the JAX
    default), batched [1, N]; and the shuffle keys. Made once a process
    (`tests/test_torch_fused.py` proves the same statement); no caller
    changes its tensors."""
    proto = DLCards(device="cpu", c=4)
    rng = GameRng(1234)
    pp = proto.setup(rng, M, N_COLS)
    pk, sk = proto.player_keygen(rng, pp)
    proof = proto.prove_key_ownership(rng, pp, pk, sk, b"d1")
    agg = proto.compute_aggregate_key(pp, [(pk, proof, b"d1")])
    cv = proto.cv
    deck = _batch1(elgamal.rand_ciphertexts(cv, rng, N, "cpu"))
    pi = torch.as_tensor(rng.permutation(N).astype(np.int64))[None]
    rho = proto._limbs([rng.scalar(cv.host.order) for _ in range(N)], (1, N))
    permuted = Ciphertexts(*(map_point(lambda t: t[:, pi[0]], c) for c in deck))
    shuffled = elgamal.cipher_add(cv, permuted, elgamal.encrypt_zero(pp.enc, agg.table, rho))
    return cv, pp, agg, device_api.make_keys(pp, agg), (deck, shuffled, pi, rho)


def _port_deck(tcv, tkeys, agg_host, generator, seed):
    """A deck, permutation, remask factors and shuffle made by the port."""
    rng = GameRng(seed)
    q = tcv.host.order
    deck = elgamal.rand_ciphertexts(tcv, rng, N, "cpu")
    pi = torch.as_tensor(rng.permutation(N).astype(np.int64))
    rho = torch.as_tensor(rng.scalar_limbs(q, (N,), tcv.fr.L).astype(np.int32))
    enc = elgamal.ElGamalParams(tcv, generator, 4, "cpu", table=tkeys.gen)
    agg = FixedBaseTable(tcv, agg_host, 4, "cpu", table=tkeys.pk)
    permuted = Ciphertexts(*(map_point(lambda t: t[pi], c) for c in deck))
    shuffled = elgamal.cipher_add(tcv, permuted, elgamal.encrypt_zero(enc, agg, rho))
    return deck, shuffled, pi, rho


def _decks():
    """The port's statement and the three decks, each batched [1, N]."""
    tcv, pp, agg, tkeys, first = _port_statement()
    decks = [first]
    for seed in (21, 22):
        d, s, p, r = _port_deck(tcv, tkeys, agg.host, pp.enc.generator, seed)
        decks.append((_batch1(d), _batch1(s), p[None], r[None]))
    return tcv, tkeys, decks


def statement_sha256(cv, deck, shuffled) -> str:
    """`STATEMENT_SHA256` of [1, N] ciphertexts (either package's curve)."""
    h = hashlib.sha256()
    for c in (*deck, *shuffled):
        for x, y, inf in cv.to_host_points(type(c)(*(t[0] for t in c))):
            h.update(x.to_bytes(32, "little") + y.to_bytes(32, "little") + bytes([inf]))
    return h.hexdigest()


def _cat(trees):
    """Concatenate NamedTuple trees of tensors along the batch axis."""
    return rebuild(trees[0], [torch.cat(xs, dim=0) for xs in zip(*map(leaves, trees))])


def _batch1(tree):
    """A NamedTuple tree of tensors with a batch axis of 1 in front."""
    return rebuild(tree, [t[None] for t in leaves(tree)])


def _at(tree, b):
    """Deck b of a batched NamedTuple tree, keeping the batch axis."""
    return rebuild(tree, [t[b : b + 1] for t in leaves(tree)])


def _rand3(q, L):
    return device_api.sample_shuffle_rand(GameRng(9), M, N_COLS, L, q, batch=3, device="cpu")


def test_proofs_equal_jax_and_cross_verify():
    tcv, tkeys, decks = _decks()
    q, L = tcv.host.order, tcv.fr.L
    assert statement_sha256(tcv, *decks[0][:2]) == STATEMENT_SHA256
    deck3, shuf3, pi3, rho3 = (_cat(list(x)) for x in zip(*decks))

    # the same randomness from one seed in both packages; deck b proves with slice b
    jrand = jdevice_api.sample_shuffle_rand(JGameRng(9), M, N_COLS, L, q, batch=3)
    rand3 = _rand3(q, L)
    for j, t in zip(jrand, rand3):
        np.testing.assert_array_equal(to_np(t), j)

    # ---- B = 1: the same proof as JAX's
    tproof = device_api.prove_shuffle(tcv, M, N_COLS, tkeys, *decks[0], _at(rand3, 0))
    assert len(leaves(tproof)) == 56
    assert sha256(leaves(tproof)) == PROOF_SHA256[0]

    # ---- B = 3: deck b's slice equals deck b's JAX proof
    leaves3 = leaves(device_api.prove_shuffle(tcv, M, N_COLS, tkeys, deck3, shuf3, pi3, rho3, rand3))
    assert [sha256([t[b : b + 1] for t in leaves3]) for b in range(3)] == PROOF_SHA256

    # ---- one port verify at B=2: deck 0 the JAX-equal proof (must pass),
    # deck 1 the same proof against a tampered deck (must fail Hadamard first)
    tdeck, tshuf = decks[0][0], decks[0][1]
    swap = [1, 0] + list(range(2, N))
    bad = Ciphertexts(map_point(lambda t: t[:, swap], tshuf.c0), tshuf.c1)
    checks = device_api.verify_shuffle(
        tcv, M, N_COLS, tkeys, _cat([tdeck, tdeck]), _cat([tshuf, bad]), _cat([tproof, tproof])
    )
    assert all(bool(c[0]) for c in checks)
    with pytest.raises(ProofVerificationError) as err:
        device_api.raise_by_flags(_at(checks, 1))
    assert err.value.name == HADAMARD


@pytest.mark.slow
def test_jax_recomputes_pins_and_accepts_port_proof():
    """The JAX statement (its `shuffle_and_remask` traces the JAX B=1 prove
    programs), the JAX B=1 proof of each deck, and the JAX verifier on the
    port's proof."""
    import jax

    from mental_poker_tpu.crypto import elgamal as jelgamal
    from mental_poker_tpu.utils.rand import ints_to_limbs

    proto = JDLCards()
    rng = JGameRng(1234)
    pp = proto.setup(rng, M, N_COLS)
    pk, sk = proto.player_keygen(rng, pp)
    proof = proto.prove_key_ownership(rng, pp, pk, sk, b"d1")
    agg = proto.compute_aggregate_key(pp, [(pk, proof, b"d1")])
    deck = jelgamal.rand_ciphertexts(proto.cv, rng, N)
    pi = rng.permutation(N)
    rho = [rng.scalar(proto.cv.host.order) for _ in range(N)]
    shuffled, _ = proto.shuffle_and_remask(rng, pp, agg, deck, rho, pi)
    bat = lambda cts: jax.tree.map(lambda a: a[None], cts)
    jdeck, jshuf = bat(deck), bat(shuffled)
    assert statement_sha256(proto.cv, jdeck, jshuf) == STATEMENT_SHA256

    tcv, tkeys, decks = _decks()
    jcv, q, L = proto.cv, proto.cv.host.order, proto.cv.fr.L
    jkeys = jdevice_api.make_keys(pp, agg)
    jrand = jdevice_api.sample_shuffle_rand(JGameRng(9), M, N_COLS, L, q, batch=3)
    jdecks = [(jdeck, jshuf, np.asarray(pi, np.int32)[None], ints_to_limbs(rho, L)[None])]
    jdecks += [tuple(to_jax_tree(x) for x in d[:2]) + (to_np(d[2]).astype(np.int32), to_np(d[3])) for d in decks[1:]]
    hashes = []
    for b, (d, s, p, r) in enumerate(jdecks):
        jr = type(jrand)(*(a[b : b + 1] for a in jrand))
        jp = jdevice_api.prove_shuffle(jcv, M, N_COLS, jkeys, d, s, p, r, jr)
        hashes.append(sha256(jax.tree.leaves(jp)))
    assert hashes == PROOF_SHA256

    tproof = device_api.prove_shuffle(tcv, M, N_COLS, tkeys, *decks[0], _at(_rand3(q, L), 0))
    jchecks = jdevice_api.verify_shuffle(jcv, M, N_COLS, jkeys, jdeck, jshuf, to_jax_tree(tproof))
    assert all(bool(np.asarray(c).all()) for c in jchecks)


@pytest.mark.slow
def test_full_deck_prove_verify_against_jax_verifier():
    """(m, n) = (2, 26), B = 1: the port proves and verifies on the CPU and
    the JAX verifier accepts the port's proof."""
    m, n = 2, 26
    proto = JDLCards()
    rng = JGameRng(4321)
    pp = proto.setup(rng, m, n)
    pk, sk = proto.player_keygen(rng, pp)
    proof = proto.prove_key_ownership(rng, pp, pk, sk, b"p")
    agg = proto.compute_aggregate_key(pp, [(pk, proof, b"p")])
    tcv = stark_curve()
    q = tcv.host.order
    tkeys = params.keys_from_jax(pp, agg, c=4, device="cpu")
    r = GameRng(5)
    Nf = m * n
    ab = torch.as_tensor(r.scalar_limbs(q, (2, 1, Nf), 16).astype(np.int32))
    enc = elgamal.ElGamalParams(tcv, pp.enc.generator, 4, "cpu", table=tkeys.gen)
    deck = Ciphertexts(enc.gen_table.mul(ab[0]), enc.gen_table.mul(ab[1]))
    pi = torch.as_tensor(np.stack([r.permutation(Nf)]).astype(np.int64))
    rho = torch.as_tensor(r.scalar_limbs(q, (1, Nf), 16).astype(np.int32))
    aggt = FixedBaseTable(tcv, agg.host, 4, "cpu", table=tkeys.pk)
    permuted = Ciphertexts(*(map_point(lambda t: torch.gather(t, 1, pi[..., None].expand(t.shape)), c) for c in deck))
    shuffled = elgamal.cipher_add(tcv, permuted, elgamal.encrypt_zero(enc, aggt, rho))
    rand = device_api.sample_shuffle_rand(r, m, n, 16, q, batch=1, device="cpu")
    tproof = device_api.prove_shuffle(tcv, m, n, tkeys, deck, shuffled, pi, rho, rand)
    device_api.raise_by_flags(device_api.verify_shuffle(tcv, m, n, tkeys, deck, shuffled, tproof))
    jkeys = jdevice_api.make_keys(pp, agg)
    jchecks = jdevice_api.verify_shuffle(
        proto.cv, m, n, jkeys, to_jax_tree(deck), to_jax_tree(shuffled), to_jax_tree(tproof)
    )
    assert all(bool(np.asarray(c).all()) for c in jchecks)
