"""The port's bench (`mental_poker_tpu_torch/bench.py`) on the CPU, at small
sizes.

- `multigame` at G = 2 games, P = 2 players, (m, n) = (1, 2), `GameRng(11)`:
  the flow's four checks (mask, remask, reveal proofs verified; cards
  unmasked) hold in every lane, and the SHA-256 of each stage's proof
  tensors equals a pinned value. The `slow` test computes the pins through
  the JAX package, following `bench.py::bench_multigame`'s flow at the
  same sizes and seed.
- `msm` at 8 points: one JSON-serialisable result with `bench.py`'s keys,
  the runs and the device.
- The command line refuses to run without a card and prints nothing.

Tolerance: exact equality of the hashed limbs.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

from mental_poker_tpu_torch import bench

from _torch_bridge import one_torch_thread, to_np  # noqa: F401

G, P, M_, N_ = 2, 2, 1, 2

# SHA-256 of the mask, remask and reveal proofs' tensors at G = 2, P = 2,
# (1, 2): t_g (x, y, inf), t_h (x, y, inf), s, limbs as little-endian
# uint32 and flags as bytes.
PROOF_SHA256 = [
    "2ac513c42e4672114e7a61121cb120859fd085190590bdf622057e728714d75d",
    "0a9dd48d339b7a2bf32452ba0516091df5b84f433e731d2b329e6033ba02995e",
    "17fbd76cca9998b3056f4fb1732ab1ac5bf34a36850faf02e7a4ed086fded8f4",
]


def proof_sha256(proof) -> str:
    h = hashlib.sha256()
    for t in (*proof.t_g, *proof.t_h, proof.s):
        a = to_np(t) if isinstance(t, torch.Tensor) else np.asarray(t)
        h.update(np.ascontiguousarray(a.astype(bool) if a.dtype == bool else a.astype("<u4")).tobytes())
    return h.hexdigest()


def test_multigame_flow_small():
    mg = bench.multigame_setup(G, P, M_, N_, device="cpu")
    out = bench.multigame_flow(mg)
    assert [c.shape[0] for c in out.checks] == [G * M_ * N_, G * M_ * N_, G * P * M_ * N_, G * M_ * N_]
    assert all(bool(c.all()) for c in out.checks)
    assert [proof_sha256(p) for p in out.proofs] == PROOF_SHA256


def test_msm_mode_result():
    res = json.loads(json.dumps(bench.bench_msm(reps=1, npts=8, device="cpu")))
    assert set(res) == {"metric", "value", "unit", "vs_baseline", "runs_s", "device"}
    assert res["metric"] == "torch_msm_8_points_per_s" and res["unit"] == "points/s/chip"
    assert len(res["runs_s"]) == 1 and res["value"] > 0 and res["device"] == "cpu"
    assert res["vs_baseline"] == round(res["value"] / bench.ARKWORKS_CPU_MSM_POINTS_PER_S, 4)
    with pytest.raises(ValueError):
        bench.run("nonesuch", device="cpu")


def test_no_card_no_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main() != 0
    assert capsys.readouterr().out == ""


@pytest.mark.slow
def test_pins_recomputed_through_jax():
    """`bench.py:263-361` in the JAX package at G = 2, P = 2, (1, 2)."""
    assert _jax_proof_hashes() == PROOF_SHA256


def _jax_proof_hashes() -> list:
    import jax.numpy as jnp

    from mental_poker_tpu.crypto import elgamal, sigma_device as sd
    from mental_poker_tpu.crypto import transcript_jax as dt
    from mental_poker_tpu.crypto.transcript import MASKING_RNG_SEED, REMASKING_RNG_SEED, REVEAL_RNG_SEED
    from mental_poker_tpu.ops import curve as curve_mod
    from mental_poker_tpu.ops.curve import PointP
    from mental_poker_tpu.utils.rand import GameRng, ints_to_limbs

    N = M_ * N_
    cv = curve_mod.stark_curve()
    fr = cv.fr
    q = cv.host.order
    rng = GameRng(11)
    gens = cv.from_host_points([cv.host.rand_point(rng.rng) for _ in range(G)])
    sks = rng.scalar_limbs(q, (G, P), fr.L)
    gens_p = PointP(*(jnp.broadcast_to(c[:, None], (G, P, c.shape[-1])) for c in gens))
    pks = cv.scalar_mul(jnp.asarray(sks), gens_p)
    agg_sk_int = [
        sum(int(sum(int(v) << (16 * i) for i, v in enumerate(sks[g, p]))) for p in range(P)) % q for g in range(G)
    ]
    agg_pk = cv.scalar_mul(jnp.asarray(ints_to_limbs(agg_sk_int, fr.L)), gens)
    L = fr.L
    flat_b = lambda Pt, reps: PointP(*(jnp.repeat(c, reps, axis=0) for c in Pt))
    g_b, pk_b = flat_b(gens, N), flat_b(agg_pk, N)
    cards = elgamal.rand_plaintexts(cv, rng, G * N)

    alphas = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    c0 = cv.scalar_mul(alphas, g_b)
    c1 = cv.add(cards, cv.scalar_mul(alphas, pk_b))
    stmt_b = cv.add(c1, cv.neg(cards))
    ks = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    prf = sd.cp_prove_dev(cv, dt.init(MASKING_RNG_SEED, (G * N,)), g_b, pk_b, c0, stmt_b, alphas, ks)
    betas = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    r0 = cv.scalar_mul(betas, g_b)
    r1 = cv.scalar_mul(betas, pk_b)
    d0 = cv.add(c0, r0)
    ks2 = jnp.asarray(rng.scalar_limbs(q, (G * N,), fr.L))
    prf2 = sd.cp_prove_dev(cv, dt.init(REMASKING_RNG_SEED, (G * N,)), g_b, pk_b, r0, r1, betas, ks2)
    M = G * P * N
    d0_b = PointP(*(jnp.repeat(c.reshape(G, 1, N, L), P, axis=1).reshape(M, L) for c in d0))
    sk_b = jnp.broadcast_to(jnp.asarray(sks)[:, :, None, :], (G, P, N, fr.L)).reshape(M, fr.L)
    tokens = cv.scalar_mul(sk_b, d0_b)
    g_bb = flat_b(gens, P * N)
    pk_pl = PointP(*(jnp.repeat(c[:, :, None], N, axis=2).reshape(M, L) for c in pks))
    ks3 = jnp.asarray(rng.scalar_limbs(q, (M,), fr.L))
    prf3 = sd.cp_prove_dev(cv, dt.init(REVEAL_RNG_SEED, (M,)), d0_b, g_bb, tokens, pk_pl, sk_b, ks3)
    return [proof_sha256(p) for p in (prf, prf2, prf3)]
