"""The port's fused latency mode (`arguments/fused.py`, `fuse_b_max`) on the
CPU, where the fused flow runs eagerly with the plain versions, against the
JAX package.

- The one-round challenge draw (`transcript_dev.sample_field_once`) equals
  the port's rejection loop and the JAX device transcript, on Stark Fr and
  BLS12-377 Fr, over a batch where some lanes need a second round of the
  loop (the JAX values pinned; the `slow` test recomputes them).
- A draw that leaves a lane undone reruns the flow staged (`FUSED_MISSES`).
- The fused flow at (2, 4), B = 1, proves the pinned JAX proof of
  `tests/test_torch_shuffle.py` (`PROOF_SHA256[0]`); the staged and the
  fused verifier accept it and reject a tampered deck.
- With the flow warmed up, the fused prove and verify make no host sync
  and build no tensor from host data.
- The dispatch rule is the JAX package's (`0 < B <= fuse_b_max`), and a
  fused flow records nothing in `STAGE_TIMES`, as the JAX package's
  `_FUSING` does. The `slow` test has the JAX package's own fused prove
  (one XLA program, about ten minutes of compile here) give the same pin.

Tolerance: every value equal, exactly.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mental_poker_tpu import config as jconfig
from mental_poker_tpu.arguments import device_api as jdevice_api
from mental_poker_tpu.arguments import staged as jstaged
from mental_poker_tpu.crypto import transcript_jax
from mental_poker_tpu.ops import curve as jcurve
from mental_poker_tpu.ops import field as jfield
from mental_poker_tpu.utils.rand import GameRng as JGameRng
from mental_poker_tpu_torch import config
from mental_poker_tpu_torch.arguments import device_api, fused, staged
from mental_poker_tpu_torch.crypto import transcript_dev
from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
from mental_poker_tpu_torch.crypto.errors import HADAMARD, ProofVerificationError
from mental_poker_tpu_torch.ops import field as tfield
from mental_poker_tpu_torch.ops.curve import map_point, stark_curve

from _torch_bridge import leaves, one_torch_thread, to_jax_tree, to_np  # noqa: F401
from test_torch_shuffle import M, N, N_COLS, PROOF_SHA256, _at, _cat, _port_statement, _rand3, sha256


# SHA-256 of the JAX transcript's four draws [512, 4, L] and keystream
# positions [512] on `_draw_inputs`, by field (`test_jax_draws_recomputed`
# recomputes them).
JAX_DRAWS_SHA256 = {
    "stark_fr": "17810b3c12f3e62f9d2c91691dac93ef1b82d90f5b4cde665322137e8423109d",
    "bls12_377_fr": "a04469801b3b3540e9f0881f27756cc0c6f9e0f5caea0de6807a4d05179b06b6",
}
DRAW_LANES, DRAWS = 512, 4


def _draw_inputs():
    """512 transcripts' absorbed bytes: on both fields some lanes of these
    need a second round of the loop's eight candidates."""
    return np.random.default_rng(12).integers(0, 256, size=(DRAW_LANES, 64), dtype=np.uint8)


@pytest.mark.parametrize("name", ["stark_fr", "bls12_377_fr"])
def test_one_round_draw_equals_loop_and_jax(name):
    """Four draws of 512 transcripts: `sample_field_once` gives the loop's
    values and keystream positions, every lane done, and the JAX
    transcript's (pinned); some lanes need a second round of the loop."""
    tf = getattr(tfield, name)()
    st = transcript_dev.absorb(transcript_dev.init(b"Shuffle Proof", (DRAW_LANES,), "cpu"),
                               torch.as_tensor(_draw_inputs()))
    nw = transcript_dev._uniform_spec(tf)[0]
    loop, once, second_round = st, st, 0
    vals = []
    for _ in range(DRAWS):
        before = loop.widx
        loop, v = transcript_dev.sample_field(loop, tf)
        second_round += int(((loop.widx - before) > transcript_dev.CANDIDATES * nw).sum())
        once, w, undone = transcript_dev.sample_field_once(once, tf)
        assert not bool(undone.any())
        assert torch.equal(w, v) and torch.equal(once.widx, loop.widx)
        vals.append(v)
    assert second_round > 0
    assert sha256([torch.stack(vals, dim=-2), once.widx]) == JAX_DRAWS_SHA256[name]


@pytest.mark.slow
@pytest.mark.parametrize("name", ["stark_fr", "bls12_377_fr"])
def test_jax_draws_recomputed(name):
    """`JAX_DRAWS_SHA256` from the JAX device transcript (about 30 s of XLA
    compile a field)."""
    jf = getattr(jfield, name)()

    def jrun(d):
        jst = transcript_jax.absorb(transcript_jax.init(b"Shuffle Proof", (DRAW_LANES,)), d)
        return transcript_jax.sample_fields(jst, jf, DRAWS)

    jst, jv = jax.jit(jrun)(jnp.asarray(_draw_inputs()))
    assert sha256([np.asarray(jv), np.asarray(jst.widx)]) == JAX_DRAWS_SHA256[name]


@pytest.fixture(scope="module")
def fused_run():
    """The statement of `tests/test_torch_shuffle.py` at (2, 4), its fused
    B = 1 proof (`fuse_b_max` = 1), and the fused verify of a B = 2 batch
    (`fuse_b_max` = 2): deck 0 the statement, deck 1 with two output cards
    swapped. This is also the warm-up of the flows' constant caches."""
    tcv, _, _, keys, (deck, shuf, pi, rho) = _port_statement()
    rand = _at(_rand3(tcv.host.order, tcv.fr.L), 0)
    swap = [1, 0] + list(range(2, N))
    bad = Ciphertexts(map_point(lambda t: t[:, swap], shuf.c0), shuf.c1)
    with config.override(fuse_b_max=1):
        proof = device_api.prove_shuffle(tcv, M, N_COLS, keys, deck, shuf, pi, rho, rand)
    batch = (_cat([deck, deck]), _cat([shuf, bad]), _cat([proof, proof]))
    with config.override(fuse_b_max=2):
        checks = device_api.verify_shuffle(tcv, M, N_COLS, keys, *batch)
    return dict(cv=tcv, keys=keys, args=(deck, shuf, pi, rho, rand), proof=proof, batch=batch, checks=checks)


def _prove(run, fuse_b_max):
    with config.override(fuse_b_max=fuse_b_max):
        return device_api.prove_shuffle(run["cv"], M, N_COLS, run["keys"], *run["args"])


def _flags(checks):
    return [[bool(v) for v in c] for c in checks]


def test_fused_flow_proves_the_jax_pin_and_verifies(fused_run):
    assert len(leaves(fused_run["proof"])) == 56
    assert sha256(leaves(fused_run["proof"])) == PROOF_SHA256[0]
    staged_checks = device_api.verify_shuffle(fused_run["cv"], M, N_COLS, fused_run["keys"], *fused_run["batch"])
    for checks in (staged_checks, fused_run["checks"]):
        flags = _flags(checks)
        assert [f[0] for f in flags] == [True, True, True]  # the honest deck
        assert not flags[0][1]  # the tampered deck fails the Hadamard argument first
    with pytest.raises(ProofVerificationError) as err:
        device_api.raise_by_flags(_at(fused_run["checks"], 1))
    assert err.value.name == HADAMARD


def test_undone_draw_reruns_staged(fused_run, monkeypatch):
    """One candidate a draw: a Stark Fr draw is then refused with
    probability about 1/2, so some draw of the flow leaves its lane undone;
    the proof is the staged flow's, the JAX pin, and the miss is counted."""
    monkeypatch.setattr(transcript_dev, "FUSED_CANDIDATES", 1)
    before = fused.FUSED_MISSES
    proof = _prove(fused_run, 1)
    assert fused.FUSED_MISSES == before + 1
    assert sha256(leaves(proof)) == PROOF_SHA256[0]


def test_fused_flow_makes_no_host_sync(fused_run, monkeypatch):
    """With the constant caches warm (the fixture's flows), the fused prove
    and verify run with every host read and every tensor built from host
    data refused inside the flow, and give the fixture's results."""
    calls = []

    def refuse(what):
        def raiser(*args, **kwargs):
            calls.append(what)
            raise AssertionError(f"{what} inside the fused flow")

        return raiser

    guarded = [(torch.Tensor, name) for name in ("__bool__", "item", "tolist", "numpy", "cpu")]
    guarded += [(torch, "tensor"), (torch, "as_tensor")]
    fusing = fused._fusing

    def fusing_guarded(flow, args):
        with monkeypatch.context() as mp:
            for owner, name in guarded:
                mp.setattr(owner, name, refuse(name))
            return fusing(flow, args)

    monkeypatch.setattr(fused, "_fusing", fusing_guarded)
    proof = _prove(fused_run, 1)
    with config.override(fuse_b_max=2):
        checks = device_api.verify_shuffle(fused_run["cv"], M, N_COLS, fused_run["keys"], *fused_run["batch"])
    assert not calls
    assert all(torch.equal(a, b) for a, b in zip(leaves(proof), leaves(fused_run["proof"])))
    assert _flags(checks) == _flags(fused_run["checks"])


# (B, fuse_b_max): fused when 0 < B <= fuse_b_max, as the JAX package's rule
DISPATCH = [(1, 1), (2, 1), (1, 0)]


@pytest.mark.parametrize("B,fuse_b_max", DISPATCH, ids=[f"B{b}-max{f}" for b, f in DISPATCH])
def test_dispatch_rule_matches_jax(monkeypatch, B, fuse_b_max):
    routes = []
    ports = staged.StagedShuffle(stark_curve(), M, N_COLS)
    monkeypatch.setattr(ports, "_fused", lambda name, flow, *a: routes.append(("port", name)))
    monkeypatch.setattr(ports, "_prove_flow", lambda *a: routes.append(("port", "staged_prove")))
    monkeypatch.setattr(ports, "_verify_flow", lambda *a: routes.append(("port", "staged_verify")))
    jaxs = jstaged.StagedShuffle(SimpleNamespace(fr=None), M, N_COLS)
    monkeypatch.setattr(jaxs, "_fused", lambda name, flow: lambda *a: routes.append(("jax", name)))
    monkeypatch.setattr(jaxs, "_prove_flow", lambda *a: routes.append(("jax", "staged_prove")))
    monkeypatch.setattr(jaxs, "_verify_flow", lambda *a: routes.append(("jax", "staged_verify")))
    pi = torch.zeros((B, N), dtype=torch.int64)
    proof = SimpleNamespace(c_a=SimpleNamespace(x=torch.zeros((B, M, 16))))
    with config.override(fuse_b_max=fuse_b_max), jconfig.override(fuse_b_max=fuse_b_max):
        for ss in (ports, jaxs):
            ss.prove(None, None, None, pi.numpy() if ss is jaxs else pi, None, None)
            ss.verify(None, None, None, proof)
    want = ["fused_prove", "fused_verify"] if 0 < B <= fuse_b_max else ["staged_prove", "staged_verify"]
    assert routes == [("port", w) for w in want] + [("jax", w) for w in want]


def test_fused_flow_records_no_stage_times(fused_run):
    staged.STAGE_TIMES.clear()
    try:
        with config.override(stage_timing=True):
            proof = _prove(fused_run, 1)
        assert staged.STAGE_TIMES == {}
    finally:
        staged.STAGE_TIMES.clear()
    assert sha256(leaves(proof)) == PROOF_SHA256[0]


@pytest.mark.slow
def test_jax_fused_prove_gives_the_pin():
    """The JAX package's fused B=1 prove (`fuse_b_max` = 1: the whole flow
    one XLA program) of the same statement and randomness: `PROOF_SHA256[0]`."""
    tcv, _, _, keys, (deck, shuf, pi, rho) = _port_statement()
    jrand = jdevice_api.sample_shuffle_rand(JGameRng(9), M, N_COLS, tcv.fr.L, tcv.host.order, batch=3)
    with jconfig.override(fuse_b_max=1):
        jproof = jdevice_api.prove_shuffle(
            jcurve.stark_curve(), M, N_COLS, to_jax_tree(keys), to_jax_tree(deck), to_jax_tree(shuf),
            to_np(pi).astype(np.int32), to_np(rho), type(jrand)(*(a[:1] for a in jrand)),
        )
    assert sha256(jax.tree.leaves(jproof)) == PROOF_SHA256[0]
