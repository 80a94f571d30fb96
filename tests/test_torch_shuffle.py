"""The port's batched shuffle prove/verify against the JAX package, on the CPU.

The statement is `tests/test_determinism.py`'s (`GameRng(1234)`, (m, n) =
(2, 4)), so the JAX programs are the ones that file compiles. Both packages
get the same statement, keys (`params.keys_from_jax`) and randomness
(`sample_shuffle_rand` from one seed); tolerance: every proof leaf equal,
exactly.

All checks against JAX live in one test, so that the JAX package traces its
B=1 prove programs (in the statement's `shuffle_and_remask`) and its B=1
verify programs once, on one worker. The port's two verifier checks share
one B=2 verify.
"""

import jax
import numpy as np
import pytest
import torch

from mental_poker_tpu.arguments import device_api as jdevice_api
from mental_poker_tpu.crypto import elgamal as jelgamal
from mental_poker_tpu.protocol.dl_cards import DLCards
from mental_poker_tpu.utils.rand import GameRng as JGameRng
from mental_poker_tpu.utils.rand import ints_to_limbs
from mental_poker_tpu_torch import params
from mental_poker_tpu_torch.arguments import device_api
from mental_poker_tpu_torch.crypto import elgamal
from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
from mental_poker_tpu_torch.crypto.errors import HADAMARD, ProofVerificationError
from mental_poker_tpu_torch.ops.curve import PointP, map_point, stark_curve
from mental_poker_tpu_torch.ops.msm import FixedBaseTable
from mental_poker_tpu_torch.utils.rand import GameRng

from _torch_bridge import leaves, one_torch_thread, rebuild, to_jax_tree, to_np, to_torch  # noqa: F401

M, N_COLS = 2, 4
N = M * N_COLS


def _jax_statement():
    """`tests/test_determinism.py::_setup`: parameters, aggregate key, a
    deck and its JAX shuffle."""
    proto = DLCards()
    rng = JGameRng(1234)
    pp = proto.setup(rng, M, N_COLS)
    pk, sk = proto.player_keygen(rng, pp)
    proof = proto.prove_key_ownership(rng, pp, pk, sk, b"d1")
    agg = proto.compute_aggregate_key(pp, [(pk, proof, b"d1")])
    deck = jelgamal.rand_ciphertexts(proto.cv, rng, N)
    pi = rng.permutation(N)
    rho = [rng.scalar(proto.cv.host.order) for _ in range(N)]
    shuffled, _ = proto.shuffle_and_remask(rng, pp, agg, deck, rho, pi)
    return proto, pp, agg, deck, pi, rho, shuffled


def _cipher_to_torch(c):
    return Ciphertexts(*(PointP(*(to_torch(np.asarray(x)) for x in p)) for p in c))


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


def _cat(trees):
    """Concatenate NamedTuple trees of tensors along the batch axis."""
    return rebuild(trees[0], [torch.cat(xs, dim=0) for xs in zip(*map(leaves, trees))])


def _batch1(tree):
    """A NamedTuple tree of tensors with a batch axis of 1 in front."""
    return rebuild(tree, [t[None] for t in leaves(tree)])


def _at(tree, b):
    """Deck b of a batched NamedTuple tree, keeping the batch axis."""
    return rebuild(tree, [t[b : b + 1] for t in leaves(tree)])


def test_proofs_equal_jax_and_cross_verify():
    proto, pp, agg, deck, pi, rho, shuffled = _jax_statement()
    jcv = proto.cv
    q = jcv.host.order
    L = jcv.fr.L
    jkeys = jdevice_api.make_keys(pp, agg)
    tcv = stark_curve()
    tkeys = params.keys_from_jax(pp, agg, c=4, device="cpu")  # the JAX default window
    bat = lambda cts: jax.tree.map(lambda a: a[None], cts)
    jdeck, jshuf = bat(deck), bat(shuffled)
    rho_c = ints_to_limbs(rho, L)[None]
    pi_b = np.asarray(pi, np.int32)[None]

    # three decks: the JAX statement's and two made by the port
    decks = [(_cipher_to_torch(jdeck), _cipher_to_torch(jshuf), torch.as_tensor(pi_b.astype(np.int64)), to_torch(rho_c))]
    for seed in (21, 22):
        d, s, p, r = _port_deck(tcv, tkeys, agg.host, pp.enc.generator, seed)
        decks.append((_batch1(d), _batch1(s), p[None], r[None]))
    deck3, shuf3, pi3, rho3 = (_cat(list(x)) for x in zip(*decks))

    # the same randomness from one seed in both packages; deck b proves with slice b
    jrand = jdevice_api.sample_shuffle_rand(JGameRng(9), M, N_COLS, L, q, batch=3)
    rand3 = device_api.sample_shuffle_rand(GameRng(9), M, N_COLS, L, q, batch=3, device="cpu")
    for j, t in zip(jrand, rand3):
        np.testing.assert_array_equal(to_np(t), j)

    # JAX proofs at B=1 (the statement traced these programs), one per deck
    jproofs = []
    for b, (d, s, p, r) in enumerate(decks):
        jr = type(jrand)(*(a[b : b + 1] for a in jrand))
        jp = jdevice_api.prove_shuffle(
            jcv, M, N_COLS, jkeys, to_jax_tree(d), to_jax_tree(s), to_np(p).astype(np.int32), to_np(r), jr
        )
        jl, treedef = jax.tree.flatten(jp)
        jproofs.append(jl)
    jleaves = jproofs[0]

    # ---- B = 1: the same proof as JAX, leaf for leaf
    tproof = device_api.prove_shuffle(tcv, M, N_COLS, tkeys, *decks[0], _at(rand3, 0))
    tleaves = leaves(tproof)
    assert len(jleaves) == len(tleaves) == 56
    for j, t in zip(jleaves, tleaves):
        np.testing.assert_array_equal(to_np(t), np.asarray(j))

    # ---- B = 3: deck b's slice equals deck b's JAX proof
    leaves3 = leaves(device_api.prove_shuffle(tcv, M, N_COLS, tkeys, deck3, shuf3, pi3, rho3, rand3))
    for b, jl in enumerate(jproofs):
        for t, j in zip(leaves3, jl):
            np.testing.assert_array_equal(to_np(t[b : b + 1]), np.asarray(j))

    # ---- one port verify at B=2: deck 0 the JAX proof (must pass), deck 1
    # the port's proof against a tampered deck (must fail Hadamard first)
    tdeck, tshuf = decks[0][0], decks[0][1]
    from_jax = rebuild(tproof, [to_torch(np.asarray(x)) for x in jleaves])
    swap = [1, 0] + list(range(2, N))
    bad = Ciphertexts(map_point(lambda t: t[:, swap], tshuf.c0), tshuf.c1)
    checks = device_api.verify_shuffle(
        tcv, M, N_COLS, tkeys, _cat([tdeck, tdeck]), _cat([tshuf, bad]), _cat([from_jax, tproof])
    )
    assert all(bool(c[0]) for c in checks)
    with pytest.raises(ProofVerificationError) as err:
        device_api.raise_by_flags(_at(checks, 1))
    assert err.value.name == HADAMARD

    # ---- the JAX verifier accepts the port's proof
    from_port = jax.tree.unflatten(treedef, [to_np(x) for x in tleaves])
    jchecks = jdevice_api.verify_shuffle(jcv, M, N_COLS, jkeys, jdeck, jshuf, from_port)
    assert all(bool(np.asarray(c).all()) for c in jchecks)


@pytest.mark.slow
def test_full_deck_prove_verify_against_jax_verifier():
    """(m, n) = (2, 26), B = 1: the port proves and verifies on the CPU and
    the JAX verifier accepts the port's proof."""
    m, n = 2, 26
    proto = DLCards()
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
