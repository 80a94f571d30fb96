"""The port's device sigma protocols (`mental_poker_tpu_torch/crypto/sigma_device.py`)
against the JAX package's `crypto/sigma_device.py` and the port's host
`crypto/sigma.py`, on the CPU.

Statements as in `tests/test_sigma_device.py`: `DLCards` at (2, 4) from
`GameRng(31)` (4-bit tables), B = 4 lanes:

- Schnorr over the generator's window table, keys sk_i * g;
- Chaum-Pedersen over the mask statement (c0, c1 - card) with two tables
  (the generator and one player's key);
- Chaum-Pedersen over a reveal statement (token = sk * c0, pk) whose first
  base is the variable point c0 (a [B] batch) and whose second is the
  generator's table.

Checks: every proof's t (x, y, inf) and s equal the JAX package's, limb for
limb (the JAX values pinned below; the `slow` test recomputes them through
the JAX package); each device proof verifies on the device and through the
port's host sigma, and each host proof verifies on the device (one verify
call for the device proof, the host proof and a tampered copy); a
response s ^ 1 is rejected in its lane only; `init_batch` of equal seeds is
`transcript_dev.init`. Tolerance: exact equality.
"""

import numpy as np
import pytest
import torch

from mental_poker_tpu_torch.crypto import elgamal, sigma
from mental_poker_tpu_torch.crypto import serialize_dev
from mental_poker_tpu_torch.crypto import sigma_device as sd
from mental_poker_tpu_torch.crypto import transcript_dev
from mental_poker_tpu_torch.crypto.errors import ProofVerificationError
from mental_poker_tpu_torch.crypto.transcript import (
    KEY_OWN_RNG_SEED,
    MASKING_RNG_SEED,
    REVEAL_RNG_SEED,
    TranscriptBatch,
)
from mental_poker_tpu_torch.ops.curve import PointP, map_point
from mental_poker_tpu_torch.ops.msm import FixedBaseTable
from mental_poker_tpu_torch.protocol.dl_cards import DLCards
from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs, limbs_to_int

from _torch_bridge import one_torch_thread, to_np  # noqa: F401

B = 4
SCHNORR_SEEDS = [KEY_OWN_RNG_SEED + bytes([i]) for i in range(B)]

# JAX `sigma_device` proofs of the three statements: per lane, the integers
# of the raw limbs of t's x and y (Montgomery form) and t's infinity flag
# (t_g then t_h for Chaum-Pedersen), then the integer of s.
JAX_PINS = {
    "schnorr": [
        [
            "0x7ef4d4b86ac66ef03d15375365c7bcb4920f18f5253ba4100ce8b42067d653",
            "0x622004652be323b15fd5ef4a8a104c79ec67ba2343915ed7b468b327ef8d89",
            False,
            "0x27ba026a4e7bdf28e80722d31ceae5c7edd561da38b7409b51fda6aaa5b0ebe",
        ],
        [
            "0x3b31c983735f8860e86c6ec1babcc40ebe2710a6e921e512eb98ddd538dd151",
            "0x497408151e0422c9d8795b07759a6760b0a9a295ca4fde14a856b11b71a788e",
            False,
            "0x3cd95cf23b6af8d908aa56eca38b21f46a556349db5ce2e6a2979fbd2bdf49",
        ],
        [
            "0x6d027b8a4883888b91894a636b1615cce5ceff38348b84e9448722c777535d6",
            "0xec8cab893684c8ce98d12825e5fee564c330f1fa9771762d9bc1a30c240dff",
            False,
            "0x389eb9fbbce50dcd51cac2b3732380c4ec12d4674c5c3cd0a53bb69f3c27d8f",
        ],
        [
            "0x21b3b8b40bc73b68a30c0ba4fcf6aa9fdd5dd292fb19880db5768ad94845026",
            "0x2d54024d0bb0663d76397d934585613b15749d2a5ca82d65dbeda529b802cdd",
            False,
            "0x591581397481ae894dc7d1e4a3c1751a3f4a8d6cd07a869e0a27cee1e89360c",
        ],
    ],
    "cp_mask": [
        [
            "0x581e1d7799e00d5c841e5d5ecf514886df2053171af65b53d792335f358c9d0",
            "0x3b3d1ecc98ececc6c96bdee4561bc6c43cb9f618522eacb45771fb1710830e6",
            False,
            "0x4c4d41244dc4883e09213234f43b0c5800a5677356a07b3fcf0e440e4a49009",
            "0x3633a9aeb6087ac868059c99d61177f9d854a9f99fcc239ceea7ead7d4e4bee",
            False,
            "0x37aa9f9fd5c096f8939d74f98f977ad04b5c9db334c5db23876d826e364eb07",
        ],
        [
            "0x197ff0b7d9cc5a924e6e621345700c658355d3eaf3ae1ad6bb53facb15bfbcc",
            "0x26f816f72ef2e8a25dc4dc260b9d118b9604a1c659cfdd31b6635092a4723be",
            False,
            "0x3f8dc722c7ba9082b4c898d4f6a27eb8b6c92c3f87fdec960b19fb27242ec9f",
            "0x6138f1a6fdc85c6da53e9e5a6fc0a997b40301e87a7eafd29b50d5d43282a02",
            False,
            "0x2bb6b6dbf679afdcf18ef711f2aa5ce2d651a8e80d1d3c28b2d302fd97e2a4c",
        ],
        [
            "0x6f8abe23cd556d58f7bac98c783d7c128cfe8c3f3eb34f08f85dc447c655aa1",
            "0x570be86f03df13d81adc42d8f9b6594cc2eeed3c66359f00754ce7e65769f6",
            False,
            "0x144e9277a34d875fe05131abf992002c535803fb27263235f689c03db4edb56",
            "0x744012f91c8d743b3370bb1941d6c1de5b8d6b08f4fc1369f173e2f47413ce1",
            False,
            "0x3e1a39f8f0ebd3b3346ed2d2e063524834ffff6d9cf848d58084a9a1fa3ec08",
        ],
        [
            "0x686482bca83f0e33196ff5cd2e5727ce73c197af870076f8be4d5fae0028bc3",
            "0x715e09e56a70cc29722814e87e0a2ed9643690aef22af0ab23605fa0b8b3bfb",
            False,
            "0x40123a6ad099b4c55ef5e2b09ab3f5d033070205af65cb5e4f6d60d69866898",
            "0x21f1395c3f6b685a7ff2371406281edf8419c7c821da0a2aed42bf3253439d4",
            False,
            "0x196c4c7ce482936b130a07c5a033f699b9ce80832a74a382e0f7bcc07e2f538",
        ],
    ],
    "cp_reveal": [
        [
            "0x6f36ab541cee20599216c14a4f0f01b622b8f0c873d00371cc1c018eda4484b",
            "0x2e26b32ef06e44a785a0d79bc699858a968f4c0c5182d2e0bd2ac8184ebfb5f",
            False,
            "0x75611f521ad8c25cd24892fe40f395057ce70e25f1d277d6c00fc9f06a4468c",
            "0x72c3e58cc886713ac87103d552f0cd6a785cf4f7dcbaef1ea3666b1d3f27196",
            False,
            "0x1317818c26dfefd0f6f8bedd5b98c6eabdb980c3369203dce2722322c39a3d0",
        ],
        [
            "0x71407cb8dfafc045534d56ed6a0e0a65f2c6fd185c29739dd7997e4886fe26c",
            "0x1aa1dd28b6b5037ffe21ed6d59141f8ae9861cc71e6e0eb0f475cb332d1c5d0",
            False,
            "0x8d35353d8be5ae907d93da08832d0737f2da2ae7be383b35215093f53fb87e",
            "0x27fcd21e0f3cb0901dc857bdde866048cdcf2cc3f964bcdb1f05f402ea7871e",
            False,
            "0x30a66ea10913d1c840cae9da3eca5daefc070bf3725aaf5cafc59a23a59f282",
        ],
        [
            "0x7b282db17c963e4f65ccce5d3661f40e95ca335307482827bebd040c2c7bdfd",
            "0x4b590bba9c3dcaf268696a2946e5a9af0851ba4c0e2d8538f2c28125a81eb76",
            False,
            "0x1187bc6a062a76db8603950a2e275847f93543e5e43227a4ef7fea709f74fd5",
            "0x2b24736bb83198ad67b53daf5a1953b19d4c4ba452f18ac44536131572d54aa",
            False,
            "0xde0a11aa79b0b3187f7bcbff7f8f0edd7af2b767aa5ac9127673aa1ce19ed9",
        ],
        [
            "0x5482a8cc303704481161fc610ef78d093df8092d2708eb3555aa1b8cb1b0eb1",
            "0x2f87af3ff78c60b9c97708a000122379c0001f543a4f0c67217904ad9561416",
            False,
            "0x9414530bc8e78301b66df387dbaaefb78ec53e4bae9f9d0dba701bc84bb3ff",
            "0x331f182f8df4c6b0cc21758b409f0fa9f4a0f505dd3dd5e5a1742191b55cf42",
            False,
            "0x7c6a434e70f66e6c2159f1132425fabe13713ea8f0a4aaf5dcab126a84b5584",
        ],
    ],
}


def _statements(proto, rng, to_dev):
    """`proto.setup` and the Schnorr statement's draws from `rng`, then one
    player's key pair (the same calls in both packages; `to_dev` makes limb
    arrays)."""
    pp = proto.setup(rng, 2, 4)
    cv = proto.cv
    order = cv.host.order
    L = cv.fr.L
    limbs = lambda vals: to_dev(ints_to_limbs(vals, L))
    sks = [rng.scalar(order) for _ in range(B)]
    pks = [cv.host.mul(s, pp.enc.generator) for s in sks]
    ks = [rng.scalar(order) for _ in range(B)]
    pk, sk = proto.player_keygen(rng, pp)
    return pp, cv, limbs, sks, pks, ks, pk, sk


def _proof_values(proof):
    """A proof's pinned values: per lane, (x, y, inf) of each t and s."""
    ts = [proof.t] if hasattr(proof, "t") else [proof.t_g, proof.t_h]
    arr = lambda a: np.asarray(to_np(a) if isinstance(a, torch.Tensor) else a)
    out = []
    for i in range(B):
        row = []
        for t in ts:
            row += [hex(limbs_to_int(arr(t.x)[i])), hex(limbs_to_int(arr(t.y)[i])), bool(arr(t.inf)[i])]
        out.append(row + [hex(limbs_to_int(arr(proof.s)[i]))])
    return out


@pytest.fixture(scope="module")
def env():
    proto = DLCards(device="cpu", c=4)
    rng = GameRng(31)
    to_dev = lambda a: torch.as_tensor(a.astype(np.int32))
    pp, cv, limbs, sks, pks, ks, pk, sk = _statements(proto, rng, to_dev)
    cards = elgamal.rand_plaintexts(cv, rng, B, "cpu")
    alphas = [rng.scalar(cv.host.order) for _ in range(B)]
    agg = FixedBaseTable(cv, pk, 4, "cpu")
    masked = elgamal.encrypt(pp.enc, agg, cards, limbs(alphas))
    ks_mask = [rng.scalar(cv.host.order) for _ in range(B)]
    ks_reveal = [rng.scalar(cv.host.order) for _ in range(B)]
    return dict(
        pp=pp, cv=cv, limbs=limbs, sks=sks, pks=pks, ks=ks, pk=pk, sk=sk, agg=agg, cards=cards,
        alphas=alphas, masked=masked, stmt_b=cv.add(masked.c1, cv.neg(cards)), ks_mask=ks_mask,
        ks_reveal=ks_reveal, tokens=cv.scalar_mul(limbs([sk] * B), masked.c0),
    )


def _cat_lanes(*trees):
    """Concatenate proofs (or points) lane-wise."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(trees)
    return type(first)(*(_cat_lanes(*parts) for parts in zip(*trees)))


def _tampered(proof, lane):
    s = proof.s.clone()
    s[lane, 0] ^= 1
    return proof._replace(s=s)


def _aff_of_hosts(cv, hosts):
    return sd.AffPt(*cv.to_affine(cv.from_host_points(hosts, "cpu")))


def _hosts_of_aff(cv, a):
    return cv.to_host_points(cv.from_affine(a.x, a.y, a.inf))


def test_init_batch_equals_init():
    st = sd.init_batch([MASKING_RNG_SEED] * 3, device="cpu")
    ref = transcript_dev.init(MASKING_RNG_SEED, (3,), device="cpu")
    assert torch.equal(st.seed, ref.seed) and torch.equal(st.widx, ref.widx)
    assert st.seed.dtype == torch.int64
    two = sd.init_batch(SCHNORR_SEEDS[:2], device="cpu")
    assert not torch.equal(two.seed[0], two.seed[1])
    assert torch.equal(two.seed[1], transcript_dev.init(SCHNORR_SEEDS[1], device="cpu").seed)


def test_base_kinds(env):
    """A [W, T, L] table is a fixed base (its point is entry [0, 1], its
    bytes broadcast over the batch); a [B] point is a variable base."""
    cv, pp = env["cv"], env["pp"]
    table = pp.enc.gen_table.table
    assert sd._is_table(table) and not sd._is_table(env["masked"].c0)
    k = env["limbs"](env["ks"])
    assert all(torch.equal(a, b) for a, b in zip(sd._mul(cv, table, k), pp.enc.gen_table.mul(k)))
    gb = sd._base_pt_bytes(cv, table, (B,))
    want = serialize_dev.point_bytes(cv, cv.from_host_points([pp.enc.generator], "cpu"))
    assert gb.shape == (B, 4 * cv.fq.L + 1) and all(torch.equal(row, want[0]) for row in gb)
    c0 = env["masked"].c0
    assert torch.equal(sd._base_pt_bytes(cv, c0, (B,)), serialize_dev.point_bytes(cv, c0))


def test_schnorr_equals_jax_and_interop(env):
    cv, pp, limbs = env["cv"], env["pp"], env["limbs"]
    gen = pp.enc.gen_table.table
    pk_dev = cv.from_host_points(env["pks"], "cpu")
    proof = sd.schnorr_prove_dev(cv, sd.init_batch(SCHNORR_SEEDS, "cpu"), gen, pk_dev, limbs(env["sks"]), limbs(env["ks"]))
    assert _proof_values(proof) == JAX_PINS["schnorr"]

    # the device proof through the host verifier
    host_view = sigma.SchnorrProof(_hosts_of_aff(cv, proof.t), [limbs_to_int(to_np(s)) for s in proof.s])
    sigma.schnorr_verify(cv, pp.enc.gen_table, env["pks"], host_view, TranscriptBatch(SCHNORR_SEEDS))
    # a host proof, the device proof and a tampered copy (lane 2) in one device verify
    hp = sigma.schnorr_prove(cv, pp.enc.gen_table, env["pks"], env["sks"], TranscriptBatch(SCHNORR_SEEDS), GameRng(32))
    from_host = sd.SchnorrProofDev(_aff_of_hosts(cv, hp.commit), limbs(hp.response))
    ok = sd.schnorr_verify_dev(
        cv, sd.init_batch(SCHNORR_SEEDS * 3, "cpu"), gen, _cat_lanes(pk_dev, pk_dev, pk_dev),
        _cat_lanes(proof, from_host, _tampered(proof, 2)),
    )
    assert ok.tolist() == [True] * 8 + [True, True, False, True]


def test_cp_mask_equals_jax_and_interop(env):
    cv, pp, limbs = env["cv"], env["pp"], env["limbs"]
    gen, agg = pp.enc.gen_table, env["agg"]
    c0, stmt_b = env["masked"].c0, env["stmt_b"]
    st = lambda n: transcript_dev.init(MASKING_RNG_SEED, (n,), "cpu")
    proof = sd.cp_prove_dev(cv, st(B), gen.table, agg.table, c0, stmt_b, limbs(env["alphas"]), limbs(env["ks_mask"]))
    assert _proof_values(proof) == JAX_PINS["cp_mask"]

    host_view = sigma.ChaumPedersenProof(
        _hosts_of_aff(cv, proof.t_g), _hosts_of_aff(cv, proof.t_h), [limbs_to_int(to_np(s)) for s in proof.s], (B,)
    )
    sigma.cp_verify(cv, gen, agg, c0, stmt_b, host_view, TranscriptBatch.fixed(MASKING_RNG_SEED, B))
    hp = sigma.cp_prove(cv, gen, agg, c0, stmt_b, env["alphas"], TranscriptBatch.fixed(MASKING_RNG_SEED, B), GameRng(33))
    from_host = sd.CPProofDev(_aff_of_hosts(cv, hp.t_g), _aff_of_hosts(cv, hp.t_h), limbs(hp.response))
    ok = sd.cp_verify_dev(
        cv, st(3 * B), gen.table, agg.table, _cat_lanes(c0, c0, c0), _cat_lanes(stmt_b, stmt_b, stmt_b),
        _cat_lanes(proof, from_host, _tampered(proof, 0)),
    )
    assert ok.tolist() == [True] * 8 + [False, True, True, True]


def test_cp_reveal_variable_base(env):
    """Bases (c0, g): the first a [B] batch of variable points."""
    cv, pp, limbs = env["cv"], env["pp"], env["limbs"]
    gen = pp.enc.gen_table
    c0, tokens = env["masked"].c0, env["tokens"]
    pk_b = map_point(lambda t: t.expand(B, -1), cv.from_host_points([env["pk"]], "cpu"))
    sk_l = limbs([env["sk"]] * B)
    st = lambda n: transcript_dev.init(REVEAL_RNG_SEED, (n,), "cpu")
    proof = sd.cp_prove_dev(cv, st(B), c0, gen.table, tokens, pk_b, sk_l, limbs(env["ks_reveal"]))
    assert _proof_values(proof) == JAX_PINS["cp_reveal"]

    host_view = sigma.ChaumPedersenProof(
        _hosts_of_aff(cv, proof.t_g), _hosts_of_aff(cv, proof.t_h), [limbs_to_int(to_np(s)) for s in proof.s], (B,)
    )
    sigma.cp_verify(cv, c0, gen, tokens, pk_b, host_view, TranscriptBatch.fixed(REVEAL_RNG_SEED, B))
    bad_view = sigma.ChaumPedersenProof(host_view.t_g, host_view.t_h, [s ^ 1 for s in host_view.response], (B,))
    with pytest.raises(ProofVerificationError):
        sigma.cp_verify(cv, c0, gen, tokens, pk_b, bad_view, TranscriptBatch.fixed(REVEAL_RNG_SEED, B))
    hp = sigma.cp_prove(cv, c0, gen, tokens, pk_b, [env["sk"]] * B, TranscriptBatch.fixed(REVEAL_RNG_SEED, B), GameRng(34))
    from_host = sd.CPProofDev(_aff_of_hosts(cv, hp.t_g), _aff_of_hosts(cv, hp.t_h), limbs(hp.response))
    three = lambda P: _cat_lanes(P, P, P)
    ok = sd.cp_verify_dev(
        cv, st(3 * B), three(c0), gen.table, three(tokens), three(pk_b),
        _cat_lanes(proof, from_host, _tampered(proof, 3)),
    )
    assert ok.tolist() == [True] * 8 + [True, True, True, False]


@pytest.mark.slow
def test_pins_recomputed_through_jax():
    """The pins above, from the JAX package's `sigma_device` on the same
    statements."""
    assert _jax_values() == JAX_PINS


def _jax_values() -> dict:
    import jax.numpy as jnp

    from mental_poker_tpu.crypto import elgamal as jelgamal
    from mental_poker_tpu.crypto import sigma_device as jsd
    from mental_poker_tpu.crypto import transcript_jax as jdt
    from mental_poker_tpu.ops.curve import PointP as JPointP
    from mental_poker_tpu.ops.msm import FixedBaseTable as JFixedBaseTable
    from mental_poker_tpu.protocol.dl_cards import DLCards as JDLCards
    from mental_poker_tpu.utils.rand import GameRng as JGameRng

    proto = JDLCards()
    rng = JGameRng(31)
    pp, cv, limbs, sks, pks, ks, pk, sk = _statements(proto, rng, jnp.asarray)
    cards = jelgamal.rand_plaintexts(cv, rng, B)
    alphas = [rng.scalar(cv.host.order) for _ in range(B)]
    agg = JFixedBaseTable(cv, pk)
    masked = jelgamal.encrypt(pp.enc, agg, cards, limbs(alphas))
    stmt_b = cv.add(masked.c1, cv.neg(cards))
    ks_mask = [rng.scalar(cv.host.order) for _ in range(B)]
    ks_reveal = [rng.scalar(cv.host.order) for _ in range(B)]
    tokens = cv.scalar_mul(limbs([sk] * B), masked.c0)
    gen = pp.enc.gen_table.table
    assert gen.x.shape[1] == 16  # 4-bit windows, as the port's tables here
    out = {}
    out["schnorr"] = _proof_values(jsd.schnorr_prove_dev(
        cv, jsd.init_batch(SCHNORR_SEEDS), gen, cv.from_host_points(pks), limbs(sks), limbs(ks)))
    out["cp_mask"] = _proof_values(jsd.cp_prove_dev(
        cv, jdt.init(MASKING_RNG_SEED, (B,)), gen, agg.table, masked.c0, stmt_b, limbs(alphas), limbs(ks_mask)))
    pk_pt = cv.from_host_points([pk])
    pk_b = JPointP(*(jnp.broadcast_to(c, (B, c.shape[-1])) for c in pk_pt))
    out["cp_reveal"] = _proof_values(jsd.cp_prove_dev(
        cv, jdt.init(REVEAL_RNG_SEED, (B,)), masked.c0, gen, tokens, pk_b, limbs([sk] * B), limbs(ks_reveal)))
    return out
