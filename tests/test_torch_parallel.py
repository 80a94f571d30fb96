"""The port's parallel layer (`mental_poker_tpu_torch/parallel/`) on the CPU.

- Cross-process, gloo: the port's dry run as real processes, world size 4
  (dp 2 x sp 2: tiers 1a-1d, among them the prefix product with the
  sequence on sp and on dp against host bigints, and tier 2) and world
  size 2, whose gathered B=2 proof must equal the single-process proof
  leaf for leaf. The parent builds the inputs once and passes them by file.
- Against the JAX package, at (m, n) = (2, 4) on numpy-seeded inputs
  (B = 4; N = 8 for the remask, the deck MSM and the commit, N = 16 for the
  window MSM and the prefix product): each sharded function at world size
  1 (a real one-rank gloo mesh) and rank by rank in one process at D = 2
  and 4 (`sharding.run_ranks`: every rank's local step in turn, the
  all_gather emulated by stacking in rank order, then the combines). The
  JAX values are
  the single-device functions that `tests/test_parallel.py` pins equal to
  the JAX sharded ones, pinned here as SHA-256s: of affine points for the
  MSMs, of limbs for the remask, the prefix product and the commit, and of
  the 56 proof leaves for the DP prove. Tolerance: exact equality. The
  `slow` test recomputes the pins through the JAX package, its sharded
  functions on the 8-device CPU mesh included.
- `gather_window_sums` over every window range at D = 1, 2, 3, 4 and 8.
"""

import functools
import hashlib
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from mental_poker_tpu_torch import params
from mental_poker_tpu_torch.arguments import device_api
from mental_poker_tpu_torch.crypto.elgamal import Ciphertexts
from mental_poker_tpu_torch.crypto.pedersen import CommitKey
from mental_poker_tpu_torch.ops import msm as msm_mod
from mental_poker_tpu_torch.ops.cuda import curve as cuda_curve
from mental_poker_tpu_torch.ops.curve import PointP, bls12_377_g1, stark_curve
from mental_poker_tpu_torch.parallel import dryrun, sharding
from mental_poker_tpu_torch.parallel.sharding import block, stack_trees, tree_map
from mental_poker_tpu_torch.utils.rand import GameRng, ints_to_limbs

from _torch_bridge import leaves, one_torch_thread, to_np, to_torch  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N_COLS, B = 2, 4, 4

# SHA-256 pins of the JAX package's single-device values on `_inputs()`:
# affine points (`sha_affine`) for the MSMs, and for the remask and the
# commit, whose fixed-base sums equal JAX's as points but not as projective
# triples; limbs (`sha_limbs`) for the prefix product and the proof leaves.
PINS = {
    "remask": "79f3f8cf5b5a8487cc681c704571790bd5e4a82d1a26110b9ab3c7aec732736e",
    "deck_msm": "93a29788910d11c6cc30c26171297c98c251b87288409bf88706a5f94a081c5c",
    "window_msm": "4414a901f3f84803f6d3810fe19206dc5330affda849f6c4d26c40bd129676d2",
    "prefix_prod": "ea645e26fc120ebd76a7308d0f5623b4b537e762280a387bba6eecce35ed56ac",
    "commit": "52323b22dcb834418abf5091ab7be1c208fe120b844c7ed3f4feead72c3a4edd",
    "prove": "174c5bf9814fcc78f8cf32d17cb87cb7ca51a69e589ab423a6ff85b9311e9ee4",
}


def sha_limbs(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        a = to_np(t) if isinstance(t, torch.Tensor) else np.asarray(t)
        h.update(np.ascontiguousarray(a.astype(bool) if a.dtype == bool else a.astype("<u4")).tobytes())
    return h.hexdigest()


def sha_affine(points) -> str:
    """Stark points (PointP of [..., L] tensors) as affine host points: x and
    y as 32 little-endian bytes, then the identity flag."""
    h = hashlib.sha256()
    for P in points:
        for x, y, inf in stark_curve().to_host_points(P):
            h.update(x.to_bytes(32, "little") + y.to_bytes(32, "little") + bytes([inf]))
    return h.hexdigest()


@functools.cache
def _inputs() -> dict:
    """The game of `params.setup(GameRng(5150), 2, 4)` with 4-bit tables,
    and numpy-seeded values: a [4, 16] deck of cards a G (its first 8
    cards the [4, 8] deck), permutations, remask and MSM scalars, Fr values
    for the prefix product, commit vectors, and the prover's randomness."""
    g = params.setup(GameRng(5150), M, N_COLS, c=4, device="cpu")
    cv = g.cv
    q, L = cv.host.order, cv.fr.L
    npr = np.random.default_rng(2027)

    def scal(*shape):
        vals = [int.from_bytes(npr.bytes(32), "little") % q for _ in range(int(np.prod(shape)))]
        return torch.as_tensor(ints_to_limbs(vals, L).reshape(shape + (L,)).astype(np.int32))

    ab = scal(2, B, 16)
    deck16 = Ciphertexts(g.enc.gen_table.mul(ab[0]), g.enc.gen_table.mul(ab[1]))
    return dict(
        g=g,
        deck16=deck16,
        deck=tree_map(lambda t: t[:, :8].contiguous(), deck16),
        pi=torch.as_tensor(np.stack([npr.permutation(8) for _ in range(B)]).astype(np.int64)),
        rho=scal(B, 8),
        k=scal(B, 8),
        k16=scal(B, 16),
        a16=cv.fr.to_mont(scal(B, 16)),
        vecs=scal(B, M, N_COLS),
        rs=scal(B, M),
        rand=device_api.sample_shuffle_rand(GameRng(9), M, N_COLS, L, q, batch=B, device="cpu"),
        ck=CommitKey(cv, g.commit_g, g.commit_h, 4, "cpu"),
    )


@pytest.fixture(scope="module")
def mesh1():
    """A real one-rank (dp 1, sp 1) gloo mesh in this process."""
    import torch.distributed as dist

    mesh = sharding.make_mesh(device="cpu")
    yield mesh
    dist.destroy_process_group()


@functools.cache
def _shuffled() -> Ciphertexts:
    inp = _inputs()
    g = inp["g"]
    return sharding.remask_shuffled_step(g.cv, g.enc.gen_table, g.agg_table)(inp["deck"], inp["pi"], inp["rho"])


def _prove_rows(inp):
    g = inp["g"]
    return lambda *rows: device_api.prove_shuffle(g.cv, M, N_COLS, g.keys, *rows)


def _functions(inp) -> dict:
    """name -> (the function's `Step`, its whole inputs, its sharded wrapper
    on the one-rank mesh)."""
    g, ck = inp["g"], inp["ck"]
    cv, deck = g.cv, inp["deck"]
    sh = sharding.shard_deck
    prove_args = (deck, _shuffled(), inp["pi"], inp["rho"], inp["rand"])
    return {
        "remask": (sharding.remask_step(cv, g.enc.gen_table, g.agg_table), (deck, inp["pi"], inp["rho"]),
                   lambda mesh: sharding.sharded_remask_step(cv, g.enc.gen_table, g.agg_table, mesh)(
                       *(sh(mesh, inp[k]) for k in ("deck", "pi", "rho")))),
        "deck_msm": (sharding.deck_msm_step(cv), (*deck, inp["k"]),
                     lambda mesh: sharding.sharded_deck_msm(cv, mesh)(*sh(mesh, deck), sh(mesh, inp["k"]))),
        "window_msm": (sharding.window_msm_step(cv), (inp["deck16"].c0, inp["k16"]),
                       lambda mesh: sharding.sharded_window_msm(cv, mesh, axis="sp")(inp["deck16"].c0, inp["k16"])),
        "prefix_prod": (sharding.prefix_prod_step(cv.fr), (inp["a16"],),
                        lambda mesh: sharding.sharded_prefix_prod(cv.fr, mesh, axis="sp")(sh(mesh, inp["a16"]))),
        "commit": (sharding.commit_step(ck), (inp["vecs"], inp["rs"]),
                   lambda mesh: sharding.sharded_commit_step(ck, mesh)(
                       *(block(inp[k], 0, *sharding.mesh_index(mesh, "dp")) for k in ("vecs", "rs")))),
        "prove": (sharding.batch_step(_prove_rows(inp), 5), prove_args,
                  lambda mesh: sharding.gather_batch(mesh, _prove_rows(inp)(
                      *(sharding.shard_batch(mesh, t) for t in prove_args)))),
    }


# the hash each function's pin is of
DIGESTS = {
    "remask": lambda out: sha_affine(list(out)),
    "deck_msm": lambda out: sha_affine(list(out)),
    "window_msm": lambda out: sha_affine([out]),
    "prefix_prod": lambda out: sha_limbs([out]),
    "commit": lambda out: sha_affine([out]),
    "prove": lambda out: sha_limbs(leaves(out)),
}


@pytest.mark.parametrize("D", [1, 2, 4])
@pytest.mark.parametrize("name", list(DIGESTS))
def test_sharded_equals_jax(mesh1, name, D):
    """D = 1: the sharded wrapper on the one-rank mesh; D = 2, 4:
    `run_ranks`, every rank's local step in turn, the gather emulated, then
    the combines."""
    step, whole, on_mesh1 = _functions(_inputs())[name]
    out = on_mesh1(mesh1) if D == 1 else sharding.run_ranks(step, D, *whole)
    assert DIGESTS[name](out) == PINS[name]


@pytest.mark.parametrize("curve", [stark_curve, bls12_377_g1])
def test_gather_window_sums_ranges(curve):
    """Window ranges of D equal parts (D = 1, 2, 3, 4, 8), the last running
    past W into padding, joined in order: the sums of every window limb for
    limb, then identities; the fold of every window equals the lane engine
    and host bigints."""
    cv = curve()
    q, L = cv.host.order, cv.fr.L
    rng = GameRng(77)
    a = rng.scalar_limbs(q, (2, 3), L).astype(np.int32)
    k = rng.scalar_limbs(q, (2, 3), L).astype(np.int32)
    base = cv.host.rand_point(rng.rng)
    P = cv.scalar_mul(torch.as_tensor(a), cv.from_host_points([base], "cpu"))
    kt = torch.as_tensor(k)
    W = -(-cv.fr.bits // cuda_curve.FOLD_WINDOW)
    assert W == cuda_curve.FOLD_W[cv.fq.L]
    whole = msm_mod.gather_window_sums(cv, P, kt, 0, W)
    for D in (1, 2, 3, 4, 8):
        Wd = -(-W // D)
        parts = [msm_mod.gather_window_sums(cv, P, kt, d * Wd, (d + 1) * Wd) for d in range(D)]
        joined = sharding.cat_parts(stack_trees(parts), axis=0)
        assert joined.x.shape[0] == D * Wd
        assert all(torch.equal(j[:W], w) for j, w in zip(joined, whole)), D
        assert bool(cv.is_identity(PointP(*(j[W:] for j in joined))).all()), D
    folded = PointP(*cuda_curve.fold_windows(cv, whole, cuda_curve.FOLD_WINDOW))
    assert bool(cv.eq(folded, msm_mod.msm(cv, P, kt, engine="lanes")).all())
    to_int = lambda v: sum(int(x) << (16 * j) for j, x in enumerate(v))
    want = [cv.host.mul(sum(to_int(a[s, i]) * to_int(k[s, i]) for i in range(3)) % q, base) for s in range(2)]
    assert cv.to_host_points(folded) == want


def test_shard_helpers_refuse_ragged_and_missing_card():
    """A shard split that does not divide raises, as the JAX shardings do;
    a CUDA process group without a card raises instead of running on the
    CPU; one process with no launcher is not distributed."""
    from mental_poker_tpu_torch.parallel import distributed

    with pytest.raises(ValueError):
        block(torch.zeros(6, 3), 0, 0, 4)
    assert block(torch.arange(8), 0, 3, 4).tolist() == [6, 7]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            distributed.backend_for("cuda")
    assert distributed.backend_for("cpu") == "gloo"
    env = {k: os.environ.pop(k) for k in ("WORLD_SIZE", "RANK") if k in os.environ}
    try:
        assert distributed.init_distributed("cpu") is False
    finally:
        os.environ.update(env)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(world: int, inputs: str, *extra: str) -> list:
    """The dry run as `world` gloo processes, torchrun's environment set by
    hand; returns the Popen objects."""
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="localhost", MASTER_PORT=str(port), WORLD_SIZE=str(world),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "mental_poker_tpu_torch.parallel.dryrun", "--device", "cpu", "--inputs", inputs, *extra]
    return [
        subprocess.Popen(cmd, cwd=REPO, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)
    ]


def _wait(procs) -> None:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a dry-run process timed out\n" + "\n---\n".join(outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
        assert f"dryrun OK rank={r}" in out, out


def test_dryrun_four_processes(tmp_path):
    """World size 4 (dp 2 x sp 2), B = 4: tiers 1a-1d (the remask's all_gather
    over sp, the deck MSM's combine, the TP window MSM, the prefix product
    with the sequence on sp and, across the dp groups, on dp) and tier 2."""
    path = str(tmp_path / "ctx.pt")
    torch.save(dryrun.build_context(batch=4, device="cpu"), path)
    _wait(_launch(4, path))


def test_dryrun_two_processes_proof_equals_single(tmp_path):
    """World size 2 (dp 1 x sp 2), B = 2: the proof gathered from the two
    ranks' B = 1 proofs equals the single-process B = 2 proof, leaf for
    leaf (computed here while the ranks run)."""
    ctx = dryrun.build_context(batch=2, device="cpu")
    path, out = str(tmp_path / "ctx.pt"), str(tmp_path / "proof.pt")
    torch.save(ctx, path)
    procs = _launch(2, path, "--out", out)
    cv = stark_curve()
    gen, pk = (msm_mod.FixedBaseTable(cv, None, table=t) for t in (ctx["keys"].gen, ctx["keys"].pk))
    shuffled = sharding.remask_shuffled_step(cv, gen, pk)(ctx["deck"], ctx["pi"], ctx["rho"])
    want = device_api.prove_shuffle(cv, M, N_COLS, ctx["keys"], ctx["deck"], shuffled, ctx["pi"], ctx["rho"], ctx["rand"])
    _wait(procs)
    got = torch.load(out, weights_only=False)
    assert len(leaves(got)) == len(leaves(want)) == 56
    assert all(torch.equal(a, b) for a, b in zip(leaves(got), leaves(want)))


@pytest.mark.slow
def test_jax_recomputes_pins():
    """The pins from the JAX package's single-device functions on the same
    inputs (72-180 s, most of it the JAX staged prover), and its
    sharded functions on the 8-device CPU mesh equal to them."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mental_poker_tpu.arguments import device as jdev
    from mental_poker_tpu.arguments import staged as jstaged
    from mental_poker_tpu.crypto.pedersen import CommitKey as JCommitKey
    from mental_poker_tpu.ops.curve import stark_curve as jstark_curve
    from mental_poker_tpu.ops.msm import FixedBaseTable as JTable
    from mental_poker_tpu.ops.msm import msm as jmsm
    from mental_poker_tpu.parallel import sharding as js

    from _torch_bridge import to_jax_tree

    inp, g = _inputs(), _inputs()["g"]
    jcv = jstark_curve()
    port = lambda Q: PointP(*(to_torch(np.asarray(c)) for c in Q))
    gen, pk = JTable(jcv, g.generator, 4), JTable(jcv, g.agg, 4)
    ck = JCommitKey(jcv, list(g.commit_g), g.commit_h)
    deck, deck16 = to_jax_tree(inp["deck"]), to_jax_tree(inp["deck16"])
    pi = to_np(inp["pi"]).astype(np.int32)
    rho, k, k16, a16 = (to_np(inp[n]) for n in ("rho", "k", "k16", "a16"))
    vecs, rs = to_np(inp["vecs"]), to_np(inp["rs"])
    mesh42, mesh24 = js.make_mesh(4, 2), js.make_mesh(2, 4)
    eq = lambda a, b: bool(np.asarray(jcv.eq(a, b)).all())

    permuted = jax.tree.map(lambda t: np.stack([np.asarray(t)[b, pi[b]] for b in range(B)]), deck)
    remask = (jcv.add(permuted.c0, gen.mul(rho)), jcv.add(permuted.c1, pk.mul(rho)))
    assert sha_affine([port(c) for c in remask]) == PINS["remask"]
    sh = js.sharded_remask_step(jcv, gen, pk, mesh42)(js.shard_deck(mesh42, deck), pi, rho)
    assert eq(sh.c0, remask[0]) and eq(sh.c1, remask[1])

    msm = (jmsm(jcv, deck.c0, k), jmsm(jcv, deck.c1, k))
    assert sha_affine([port(c) for c in msm]) == PINS["deck_msm"]
    k_sh = jax.device_put(k, NamedSharding(mesh42, P("dp", "sp", None)))
    p0, p1 = js.sharded_deck_msm(jcv, mesh42)(*js.shard_deck(mesh42, deck), k_sh)
    assert eq(p0, msm[0]) and eq(p1, msm[1])

    window = jmsm(jcv, deck16.c0, k16)
    assert sha_affine([port(window)]) == PINS["window_msm"]
    assert eq(js.sharded_window_msm(jcv, mesh24, axis="sp")(deck16.c0, k16), window)

    fr = jcv.fr
    prefix = jax.numpy.moveaxis(fr._prefix_prod_scan(jax.numpy.moveaxis(a16, 1, 0)), 0, 1)
    assert sha_limbs([prefix]) == PINS["prefix_prod"]
    assert (np.asarray(js.sharded_prefix_prod(fr, mesh24, axis="sp")(a16)) == np.asarray(prefix)).all()

    commit = ck.commit(vecs, rs)
    assert sha_affine([port(commit)]) == PINS["commit"]
    assert eq(js.sharded_commit_step(ck, mesh42)(vecs, rs), commit)

    jkeys = jdev.ShuffleKeys(gen=gen.table, pk=pk.table, ckg=ck.g_msm.table, ckh=ck.h_table.table,
                             sgen=JTable(jcv, g.shuffle_generator, 4).table)
    shuffled = to_jax_tree(_shuffled())
    proof = jstaged.get_staged(jcv, M, N_COLS).prove(jkeys, deck, shuffled, pi, rho, to_jax_tree(inp["rand"]))
    assert sha_limbs(jax.tree.leaves(proof)) == PINS["prove"]
