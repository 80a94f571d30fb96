"""The port's `DLCards` protocol against the JAX package, on the CPU.

The game is `tests/test_protocol.py`'s: Stark, (m, n) = (2, 4), `GameRng(2024)`,
4 players, each with 8 bytes of public info. One seeded run of the same
calls (setup, keys, key-ownership proofs, aggregate key, mask, remask, the
players' reveal tokens, unmask) draws the same randomness in both packages,
so parameters, keys, decks, tokens and every proof's `proof_io` bytes are
equal. The JAX values are pinned below (hex of compressed points and of
`proof_io` bytes); the `slow` test recomputes them live. Tampered proofs
raise the reference's strings. Tolerance: exact equality of bytes.
"""

import types

import pytest

from mental_poker_tpu.crypto import proof_io as jproof_io
from mental_poker_tpu_torch import params
from mental_poker_tpu_torch.crypto import elgamal, proof_io
from mental_poker_tpu_torch.crypto.errors import CHAUM_PEDERSEN, SCHNORR, CardProtocolError, ProofVerificationError
from mental_poker_tpu_torch.crypto.serialize import point_to_bytes_compressed
from mental_poker_tpu_torch.ops.curve import bls12_377_g1
from mental_poker_tpu_torch.protocol import api
from mental_poker_tpu_torch.protocol.dl_cards import DLCards
from mental_poker_tpu_torch.utils.rand import GameRng

from _torch_bridge import one_torch_thread  # noqa: F401

# `_play(DLCards(), GameRng, elgamal)` run by the JAX package
# (mental_poker_tpu.protocol.dl_cards / crypto.elgamal / utils.rand).
PIN = {
    'params': (
        "1087f464627b7024daf5f1cca28547eaa0cbcef9048d487af1f5889425d6ae07"
        "d5be5ad282a7fa7222b061a0d6d0f9c524da6df1d234f2062ea13125f3461687"
        "8f4dafa022bc34ec4a15587505c05e3a6dd995992f269134e081f001d45c8805"
        "ed60524cf7ccca757a3b605e29f841c3ba2865894dc228ed78dbe2ab38225c81"
        "043776a35b151f228381db111efd34308b50f76b53de70ff94873274a0843b07"
        "f2e648a6655803e4470e118acf0189373cbc4864dc973ce86b45d7e9de457000"
        "8cef1978756c025f341cd78dc767fe1a58e8594683f46f54ac1f51a6fc6d5085"
    ),
    'keys': (
        "77e98f58679e958a3de24101ed39d140c5cd1dfacbf748d741985e52f4da7307"
        "ee7ae77caee59a23876c14e3d88f35d88a2dcbcca88492efa72b19ff7500a107"
        "0509e5fdfe5094cbed64480cc1fc4f6964f41e10fbaf12dd07e0b03dcde8e907"
        "2a6655a82d9db5efd5bc76529432baf815991cd43e6255682ce286d3178c9d84"
    ),
    'infos': '0d2c752759d058f4da3fa6bb1f44cf17c5622fcec80e1b1069d7e017e2d39f8f',
    'schnorr': [
        (
            "0100000000000000634085b2e973c52dc8d9347daf08b360474bc9ccafb623a2"
            "522daee2c5306f0401000000000000005e6eb9f2060de7b712b8c69957a35144"
            "d56eeecb593283bc9c60b7aaca4a4900"
        ),
        (
            "0100000000000000731d8a8a5295f6555848c825b54409ee17cb0b09f4fb7754"
            "76e55723d9e6a40101000000000000007a1737536882e2fdbf3e175a637f7e84"
            "591d098f2a4e58c30b05c9347d383406"
        ),
        (
            "01000000000000008d267575f8f161e45e84149f77db68ad108b068c9cb85894"
            "a9fdfb3f41303f810100000000000000ccb88d9bbc52d80ec07f8c7daf0ed543"
            "55925d88f70c6da13c91275fa51c2004"
        ),
        (
            "0100000000000000eaeb549a16c3bd45a4613b34e74fbc419ac936b96dd6d6af"
            "2676b76a0fc4c2070100000000000000955d3e04f805f899afec457225bf388c"
            "ac6b3b344de80dc9ee5437ee6cc87000"
        ),
    ],
    'aggregate': '4350f4ef92ceb09dc42635e8bfc0bd0c2e62a5d71838223676e7fe0aa5553782',
    'masked': (
        "7999244cc90d2251407f418baf96cfac7dccc6ecc2ff7be4b6352eeae9151585"
        "3cf00d9d574610abc96af3ed7fd1d91a3b3e05edfb855cc6f7e4f0726653d504"
        "d191c377ab9e49cfa34d74788b6a5077f371d28fa9d3e338d7e47db2f5f28905"
        "a6adc63ea4d7ef2ca07b8fd7a030b8ed71f7442ede0e072dff4dedb2b0d74802"
        "f7bae43b5285f759cbd9c98c8757c4bb823abc180777dd0266a9d0838c4d6682"
        "a81cdd42a89fec3bf5dd26011b7538f6716ef2d9d6b4d8a62afa53ede09da285"
    ),
    'mask_proof': (
        "03000000000000004d8e83f1192ca120e42dd5b46aa6c840b987fbc06397115a"
        "aa48d21747b4fa070241a4effce157372b9d9230aeb35552512f83dc1d15f536"
        "c38c4f560b000385be563a8e071c480f0cd03ed9b34e46b4eee5e751d89c361d"
        "a99c2657b321d9050300000000000000a1207f7092b3abfa5453501289462d1d"
        "f9da3f18671895069891b59ca1a0b0041cfe49607ee450263a73e48ea5c24494"
        "96272bd13cfcbb9e2d41a1d9214035835d6dee4c0fc0f0a67b5605dc7fa26b02"
        "20dab1f4d4ac504ec45db8d239e2c28703000000000000008911e177303aaa82"
        "25a396918d6520b2780ac9761d8e5de7e330c24feccd45071c3ec729f84e35d3"
        "39fcfb85139df89dc048aca7e1214633456718d7f85f350100e76dab3551e43e"
        "95f93fee1ed38a8f8e18bfcc7ecfc830ea40b8dd9ae0ed04"
    ),
    'remasked': (
        "fcd6c495e93dd2a67f83b19abdcde9d120fd478fe05d2f8e9b4758ef8dc14100"
        "4e13df6111ec4794acb3c6b470f98e28f598e01a1b6d0107c8b5ccdb2e29a181"
        "fa6bbfb1f6b919f44924db3361d6522e76aefdcaa24b580706e2723f7f47d482"
        "938f97699e14de0024b81e404853bbd300d970e0ac96783997ff474bbd5f5f80"
        "5354b5a13e5602590f4590cfd669de4cf6c61b73c72fdc1488a568f97d7a2303"
        "43b7161f4ab5c1aab49c1b52fa6ff558665b1b8a27e6b7737a8dd010e52e8685"
    ),
    'remask_proof': (
        "0300000000000000e45c57043cadfeb9b0a60d470cdfd02c50ad7e5d3708e37b"
        "06c7e0209d549983919a716dc6b439344a9adfded9a18bd7696da84a638ca03d"
        "98ce0207e1c3b4804f4cb467e7829930ea8ebd572c8f55ea4bc96733f6ccb8da"
        "6e6bb3210097f6060300000000000000b1e875a1eab9e203631b1fea88dd0bd0"
        "f9861883ee1ded4fba662bdbb8f2008449fc84a5b8975ec0bf002f9ebb55ec80"
        "648492356b199b47b48feab158fdd7031b59976f9843a688193695e02b38a287"
        "1d1619bf1883206c85af35b680f54f84030000000000000048c9f8b38b5294e9"
        "f2f9a57c7934cb80de9e78ccf6654e71a9b0e3d87bac8d00b76d5b246be3967d"
        "ec84bf821a0765f5e335ae74844bd4fe28aa3a76f7d0a4045b32ae3f8973c144"
        "f302a3b73a18a2bb6f656d59565fa8d1c5e5f03aeeca9104"
    ),
    'tokens': (
        "3518dbeb002b69d3c304eb8466312628334093c468e7f6275e5f468929d5de04"
        "cf18b42d18e2abe6b6383960b4cb62001e793bd75f1776f2c8b5eabc266c3986"
        "93c3d78626af1bf6b392a7aaf20cef191c59877ec685f0966aa9942bfc4fc381"
        "ec9ba646cf0a0c26f6b5c99940f3d7b95128480f68dc063b6e95336312932402"
        "658dac93e6678136b7042e4dcd059881db6824fe494569b6c6756c5a208ae502"
        "a1e068f998307ec8be363046d72390d30a354ee230733be1c920371198010783"
        "27b6b097428640fb8a39df818bb40f43a3c26e1a1774be3497b1a5aac1e25587"
        "82c296451577f2047c029bb51ab66d23ecb8bf1caf53b84014cb71cd636eda05"
        "0856ea9db685c3cae3bb14947853cd2643c1de738d33c061a27d3804887fac03"
        "bcd648cfc0c1c6910ccb806e5cacc1f6d5f84922ae1cacc39cdd2491b8d59d02"
        "220aab100e3828ae88d4216dfaa6e71391bb136a5a041af2e93bbdfd26616687"
        "8ec8fbb4abd4fb8c4d19e7c34c4f64f1fb6d12d0ffbc4e4df8292a41772d9607"
    ),
    'reveal_proofs': [
        (
            "0300000000000000c1fddafd34d4bb8ef23b674e6311198991f93f8350834c70"
            "1745e9899b6cce861ce26ae741536be8f99465d03acc460e08c93672302824a7"
            "add5677005175906f1281ed5389e8416692c6b866a90373cbb31baca56bfc292"
            "0e8cbbfd7b7b0d820300000000000000276cb195f6d35bc10254d1dfc2b3024b"
            "650619f4f35b6e449411c3afb3e8d005334192450e082a3bb48a1d2e1d93a928"
            "327dce4b28ec83fc6e8cf56abef108009c92e12885781ad2642b3e1ec4e0a631"
            "395ffc4bb3f3464d4902d3ddad9a8d80030000000000000016eaa91bcf127dbf"
            "5722b9ab9b803232de20af8c3f8590fb90ecdc8d85002e03e96d294264cd9762"
            "cfd1a583d3d1530256262d4f3fd8dfc31d7c426e8c428a00bd26f451ceaf68a9"
            "1c4ee594b31ae60573c540a394132f89567903ba094d4a06"
        ),
        (
            "03000000000000008d7ce5f10277be0f41223ec3c4ecf916c0ac02a3471e282f"
            "f4b82f87ff3bdd074da567a6fb3ce8df90ecdcbcf232449cba96bc330efd4f09"
            "731197bafbd45b03b8fb57b0c9e91bdc9e71916800591d8b8d3eb7fe86bedc9c"
            "01ac9b345ffbd2840300000000000000c62914c1515998f7ca3bf5d8f8c7eaa8"
            "acf98132337d0a02dd84708c0af1f2028ff64b8310ca42033f31002799ef5c47"
            "2aee7b55f6fe91a9f63284830719a801854b95e05ccaeb437795bc7b843df26e"
            "3627ca2962501b7edbcd6f95361c84870300000000000000d700b3976d8e0064"
            "6475e31840dff9385cd36f05bfba083dc492a74f60c248025f3570cb77e609cf"
            "4e7bb0a38e2257ad18daff65af96cf66ec681f8959a90701081f8ef54d9031f2"
            "0b0702dc82f2f3d7b6de491ad9db6d3aacb3caf91bf07005"
        ),
        (
            "03000000000000003d6f282b61bc55d4fa0e3709011a37d47ef6bfb255880848"
            "36502d9d2f8ed10678ef9cc4f94bb49554bdc9c740c279691816c3d58ecf6010"
            "b119faf79a66e78174e43d9193bd825f6e6858f964c9e690a53f210df224e54f"
            "4fcaf6b6d38a38000300000000000000213ae70d4e7a32bb8b802a6ac47e1385"
            "36bf8daf3984565e6cefb7e5bb4d2e808c36a5770ca91cf25a3873a00ca32b05"
            "911d0c9f170f807f76ed9fb391b17e000d2cfc75972bd5d2c7dc543139e3b2f1"
            "b332a9d38ab4f9b42c034c136b60b884030000000000000039b3ef420ab550d9"
            "535e00b8ed65a97065ad58f329bc1ed8dd73a5191b431802b1e4efbad353ce54"
            "e6dd3231cc0bb5ce0ac11b80125eaf50af346d029401fb057c802e4514b3f2d9"
            "ed13c803be704fc20bcc73fc67884f03e7de033536cf1405"
        ),
        (
            "030000000000000057cf603631a4a9da3e77186ad342066e91b2f290a514d10e"
            "202e6d9baa524f846f25da02c6d5f1c92679de4ca0c7b20f1cb76cbb86817940"
            "68768776e23c6e87ecf7f68463e3c3c5e756b78055dafef068053e011259a712"
            "72177f23c2fbad0103000000000000004041b9e80c0c3ccd7c17217e7318f8df"
            "0cd4882d3fa7769cb26f31afdbffbc839650d177ba41cab0c7067d11cf282fbf"
            "18d391bba6f3222a68a3d017de2075020ed921589c1dd392c2d9166c682ff1e9"
            "a29a032b6a8127502d59b426f46291860300000000000000509e4f4c9d20e038"
            "37b4ce59e229f2e6cf14a5e37adee902262ba4075a111904f748275846dd6ae4"
            "2fda1c54a853bb90ab4bfd4f8abb814500558c442b128701e6a4cb1541ad502f"
            "2eb266cad7429cc428833eef8ccf74eda3931b43388db804"
        ),
    ],
}


def _pts_hex(pts, curve) -> str:
    return b"".join(point_to_bytes_compressed(p, curve) for p in pts).hex()


def _play(proto, rng_cls, elg, proof_io_mod, **dev):
    """The seeded run shared by both packages; returns the game's objects
    and its values as hex strings."""
    cv = proto.cv
    h = cv.host
    q = h.order
    rng = rng_cls(2024)
    pp = proto.setup(rng, 2, 4)
    players = []
    for _ in range(4):
        pk, sk = proto.player_keygen(rng, pp)
        players.append((pk, sk, rng.bytes(8)))
    infos = [(pk, proto.prove_key_ownership(rng, pp, pk, sk, info), info) for pk, sk, info in players]
    agg = proto.compute_aggregate_key(pp, infos)
    cards = elg.rand_plaintexts(cv, rng, 3, **dev)
    alphas = [rng.scalar(q) for _ in range(3)]
    masked, mproof = proto.mask(rng, pp, agg, cards, alphas)
    remasked, rproof = proto.remask(rng, pp, agg, masked, [rng.scalar(q) for _ in range(3)])
    dkey = [(*proto.compute_reveal_token(rng, pp, sk, pk, masked), pk) for pk, sk, _ in players]
    values = {
        "params": _pts_hex([pp.enc.generator, *pp.commit_key.g_hosts, pp.commit_key.h_host, pp.shuffle_generator], h),
        "keys": _pts_hex([p[0] for p in players], h),
        "infos": b"".join(p[2] for p in players).hex(),
        "schnorr": [proof_io_mod.schnorr_to_bytes(i[1], h).hex() for i in infos],
        "aggregate": _pts_hex([agg.host], h),
        "masked": _pts_hex(cv.to_host_points(masked.c0) + cv.to_host_points(masked.c1), h),
        "mask_proof": proof_io_mod.chaum_pedersen_to_bytes(mproof, h).hex(),
        "remasked": _pts_hex(cv.to_host_points(remasked.c0) + cv.to_host_points(remasked.c1), h),
        "remask_proof": proof_io_mod.chaum_pedersen_to_bytes(rproof, h).hex(),
        "tokens": _pts_hex([p for tok, _, _ in dkey for p in cv.to_host_points(tok)], h),
        "reveal_proofs": [proof_io_mod.chaum_pedersen_to_bytes(pr, h).hex() for _, pr, _ in dkey],
    }
    game = types.SimpleNamespace(
        proto=proto, rng=rng, pp=pp, players=players, infos=infos, agg=agg, cards=cards,
        masked=masked, mproof=mproof, remasked=remasked, rproof=rproof, dkey=dkey,
    )
    return game, values


@pytest.fixture(scope="module")
def game():
    return _play(DLCards(device="cpu"), GameRng, elgamal, proof_io, device="cpu")


def test_protocol_values_equal_jax(game):
    _, values = game
    assert values == PIN


def test_dlcards_implements_all_traits():
    d = DLCards(device="cpu")
    for trait in (api.BarnettSmartProtocol, api.Mask, api.Remask, api.Reveal):
        assert isinstance(d, trait)
    assert len(api.BarnettSmartProtocol.__abstractmethods__) == 14


def test_key_ownership(game):
    g, _ = game
    proto, pp, rng = g.proto, g.pp, g.rng
    pk, sk, info = g.players[0]
    proto.verify_key_ownership(pp, pk, info, g.infos[0][1])
    wrong = proto.prove_key_ownership(rng, pp, pk, rng.scalar(proto.cv.host.order), info)
    with pytest.raises(ProofVerificationError) as ei:
        proto.verify_key_ownership(pp, pk, info, wrong)
    assert ei.value.name == SCHNORR
    bad = [(proto.cv.host.identity, g.infos[0][1], g.infos[0][2])] + g.infos[1:]
    with pytest.raises(CardProtocolError) as ei:
        proto.compute_aggregate_key(pp, bad)
    assert ei.value.inner.name == SCHNORR


def test_mask_and_remask_verify(game):
    g, _ = game
    proto, pp = g.proto, g.pp
    proto.verify_mask(pp, g.agg, g.cards, g.masked, g.mproof)
    proto.verify_remask(pp, g.agg, g.masked, g.remasked, g.rproof)
    # a proof read back from its bytes verifies too
    back = proof_io.chaum_pedersen_from_bytes(proof_io.chaum_pedersen_to_bytes(g.mproof, proto.cv.host), proto.cv.host)
    proto.verify_mask(pp, g.agg, g.cards, g.masked, back)
    wrong = elgamal.rand_ciphertexts(proto.cv, g.rng, 3, "cpu")
    with pytest.raises(ProofVerificationError) as ei:
        proto.verify_mask(pp, g.agg, g.cards, wrong, g.mproof)
    assert ei.value.name == CHAUM_PEDERSEN


def test_unmask_gives_cards_back(game):
    g, _ = game
    proto, pp, cv = g.proto, g.pp, g.proto.cv
    plain = proto.unmask(pp, g.dkey, g.masked)
    assert cv.to_host_points(plain) == cv.to_host_points(g.cards)
    tok0, proof0, pk0 = g.dkey[0]
    bad = [(elgamal.rand_plaintexts(cv, g.rng, 3, "cpu"), proof0, pk0)] + g.dkey[1:]
    with pytest.raises(CardProtocolError) as ei:
        proto.unmask(pp, bad, g.masked)
    assert ei.value.inner.name == CHAUM_PEDERSEN


@pytest.mark.slow
def test_bls_mask_reveal_unmask():
    """`tests/test_bls_protocol.py::test_bls_mask_reveal_roundtrip` on the
    port: BLS12-377 G1, `GameRng(17)`, (2, 2)."""
    proto = DLCards(bls12_377_g1(), device="cpu")
    rng = GameRng(17)
    pp = proto.setup(rng, 2, 2)
    pk, sk = proto.player_keygen(rng, pp)
    kproof = proto.prove_key_ownership(rng, pp, pk, sk, b"bls")
    agg = proto.compute_aggregate_key(pp, [(pk, kproof, b"bls")])
    cards = elgamal.rand_plaintexts(proto.cv, rng, 4, "cpu")
    alphas = [rng.scalar(proto.cv.host.order) for _ in range(4)]
    masked, mproof = proto.mask(rng, pp, agg, cards, alphas)
    proto.verify_mask(pp, agg, cards, masked, mproof)
    token, tproof = proto.compute_reveal_token(rng, pp, sk, pk, masked)
    proto.verify_reveal(pp, pk, token, masked, tproof)
    plain = proto.unmask(pp, [(token, tproof, pk)], masked)
    assert proto.cv.to_host_points(plain) == proto.cv.to_host_points(cards)
    with pytest.raises(ProofVerificationError) as ei:
        proto.verify_reveal(pp, pk, proto.cv.neg(token), masked, tproof)
    assert ei.value.name == CHAUM_PEDERSEN


@pytest.mark.slow
def test_pins_against_live_jax(game):
    """Recompute the pin through the JAX package; the JAX verifiers accept
    the port's mask and reveal proofs read back from their bytes."""
    from mental_poker_tpu.crypto import elgamal as jelgamal
    from mental_poker_tpu.protocol.dl_cards import DLCards as JDLCards
    from mental_poker_tpu.utils.rand import GameRng as JGameRng

    jg, jvalues = _play(JDLCards(), JGameRng, jelgamal, jproof_io)
    assert jvalues == PIN == game[1]
    g, _ = game
    h = jg.proto.cv.host
    jg.proto.verify_mask(jg.pp, jg.agg, jg.cards, jg.masked, jproof_io.chaum_pedersen_from_bytes(
        proof_io.chaum_pedersen_to_bytes(g.mproof, h), h))
    # the port's protocol objects rebuilt from the JAX ones verify the JAX mask proof
    tpp, tagg = params.protocol_from_jax(jg.pp, jg.agg, device="cpu")
    jc = jg.proto.cv
    to_port = lambda P: g.proto.cv.from_host_points(jc.to_host_points(P), "cpu")
    masked = elgamal.Ciphertexts(to_port(jg.masked.c0), to_port(jg.masked.c1))
    proof = proof_io.chaum_pedersen_from_bytes(jproof_io.chaum_pedersen_to_bytes(jg.mproof, h), h)
    g.proto.verify_mask(tpp, tagg, to_port(jg.cards), masked, proof)
