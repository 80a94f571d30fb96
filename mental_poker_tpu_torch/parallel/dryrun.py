"""Multi-process dry run of the parallel layer (counterpart of
`__graft_entry__.py`'s `dryrun_multichip`; its `entry()` step, the
one-device shuffle+remask, is tier 1a's reference).

    python -m torch.distributed.run --nproc_per_node=N -m mental_poker_tpu_torch.parallel.dryrun [--device cpu]
    python -m mental_poker_tpu_torch.parallel.dryrun [--device cpu]     # alone: world size 1

One process per card on "cuda" (NCCL), or per CPU process on "cpu" (gloo).
The ranks form a (dp, sp) mesh, sp = 2 when the world size is even, and
run on (m, n) = (2, 4) decks, a batch of max(world size, 2):

1a. the dp x sp sharded permute + remask, each rank's block equal limb for
    limb to the one-device step on its rows;
1b. the dp x sp sharded deck MSM, each rank's sums equal to host bigints;
1c. the TP window-sharded MSM over sp, equal as points to 1b;
1d. the sharded prefix product with the sequence on sp, then on dp,
    against host bigints (the cross-process path of the JAX package's
    `tests/_distributed_child.py`);
2.  the staged prove + verify with the batch split over dp x sp
    (`shard_batch`), the proof and flags gathered (`gather_batch`), every
    flag true.

`--inputs FILE` reads the context
(`build_context`, saved with `torch.save`) instead of building it on every
rank; `--out FILE` has rank 0 save the gathered proof there. A progress
line is flushed after each tier. Any failure raises, so the process exits
non-zero; there is no time budget that skips a tier.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import params
from ..arguments import device_api
from ..crypto.elgamal import Ciphertexts
from ..ops.curve import PointP, stark_curve
from ..ops.field import stark_fq
from ..ops.msm import FixedBaseTable
from ..utils.rand import GameRng, ints_to_limbs
from . import sharding
from .distributed import global_mesh, init_distributed


def build_context(m: int = 2, n: int = 4, batch: int = 2, seed: int = 11, device="cuda") -> dict:
    """The dry run's inputs from `seed`: the game's window tables
    (`params.setup`, 4-bit windows), a [batch, m n] deck of random cards
    a G, permutations, remask scalars, the deck MSM's scalars and the
    prover's randomness."""
    dev = torch.device(device)
    g = params.setup(GameRng(seed), m, n, c=4, device=dev)
    q, L, N = g.cv.host.order, g.cv.fr.L, m * n
    rng = GameRng(seed + 1)
    scalars = lambda shape: torch.as_tensor(rng.scalar_limbs(q, shape, L).astype(np.int32), device=dev)
    ab = scalars((2, batch, N))
    deck = Ciphertexts(g.enc.gen_table.mul(ab[0]), g.enc.gen_table.mul(ab[1]))
    pi = torch.as_tensor(np.stack([rng.permutation(N) for _ in range(batch)]).astype(np.int64), device=dev)
    rho, k = scalars((batch, N)), scalars((batch, N))
    rand = device_api.sample_shuffle_rand(rng, m, n, L, q, batch=batch, device=dev)
    return dict(m=m, n=n, keys=g.keys, deck=deck, pi=pi, rho=rho, k=k, rand=rand)


def unshard_deck(mesh, tree):
    """The whole [B, N] tree from every rank's `shard_deck` block."""
    rows = sharding.cat_parts(sharding.all_gather_tree(mesh, "sp", tree), axis=1)
    return sharding.cat_parts(sharding.all_gather_tree(mesh, "dp", rows), axis=0)


def _host_msm(cv, pts: PointP, k) -> list:
    """sum_i k[b, i] pts[b, i] for each row b, with host bigints."""
    to_int = lambda v: sum(int(x) << (16 * j) for j, x in enumerate(v))
    B, N = k.shape[:2]
    hp = cv.to_host_points(pts)
    hk = k.cpu().numpy().reshape(B * N, -1)
    out = []
    for b in range(B):
        acc = cv.host.identity
        for i in range(b * N, (b + 1) * N):
            acc = cv.host.add(acc, cv.host.mul(to_int(hk[i]), hp[i]))
        out.append(acc)
    return out


def tier1(mesh, ctx: dict, progress) -> Ciphertexts:
    """Tiers 1a-1d on this rank; returns the whole shuffled deck [B, N]."""
    cv = stark_curve()
    keys = ctx["keys"]
    gen, pk = FixedBaseTable(cv, None, table=keys.gen), FixedBaseTable(cv, None, table=keys.pk)
    deck, pi, rho, k = ctx["deck"], ctx["pi"], ctx["rho"], ctx["k"]

    # 1a. permute + remask, dp x sp
    out_sh = sharding.sharded_remask_step(cv, gen, pk, mesh)(
        sharding.shard_deck(mesh, deck), sharding.shard_deck(mesh, pi), sharding.shard_deck(mesh, rho)
    )
    i, n_dp = sharding.mesh_index(mesh, "dp")
    rows = lambda t: sharding.block(t, 0, i, n_dp)
    want = sharding.remask_shuffled_step(cv, gen, pk)(
        sharding.tree_map(rows, deck), sharding.shard_deck(mesh, pi), sharding.shard_deck(mesh, rho)
    )
    if not all(torch.equal(a, b) for a, b in zip(sharding.leaves(out_sh), sharding.leaves(want))):
        raise AssertionError("tier 1a: the sharded remask differs from the one-device step")
    shuffled = unshard_deck(mesh, out_sh)
    progress("tier1a OK: dp x sp sharded permute+remask equals the one-device step")

    # 1b. deck MSM, dp x sp
    k_sh = sharding.shard_deck(mesh, k)
    p = sharding.sharded_deck_msm(cv, mesh)(out_sh.c0, out_sh.c1, k_sh)
    my = sharding.tree_map(rows, shuffled)
    for got, pts in ((p.c0, my.c0), (p.c1, my.c1)):
        if cv.to_host_points(got) != _host_msm(cv, pts, rows(k)):
            raise AssertionError("tier 1b: the sharded deck MSM differs from host bigints")
    progress("tier1b OK: SP deck-sharded MSM equals host bigints")

    # 1c. TP window MSM over sp, equal to 1b
    t0 = sharding.sharded_window_msm(cv, mesh, axis="sp")(my.c0, rows(k))
    if not bool(cv.eq(t0, p.c0).all()):
        raise AssertionError("tier 1c: TP window-sharded MSM != SP deck-sharded MSM")
    progress("tier1c OK: TP window-sharded MSM == SP deck-sharded MSM")

    # 1d. prefix product, the sequence on sp and then on dp
    fq = stark_fq()
    world = mesh.size()
    B, N = world, 4 * world
    vals = np.random.default_rng(0).integers(1, 1 << 62, size=(B, N)).tolist()
    a = fq.tensor(np.stack([fq.from_int_array(row) for row in vals]), deck.c0.x.device)
    expect = []
    for row in vals:
        acc, pre = 1, []
        for v in row:
            acc = acc * v % fq.p
            pre.append(acc)
        expect.append(pre)
    expect = fq.tensor(ints_to_limbs(expect, fq.L), a.device)
    for axis, other in (("sp", "dp"), ("dp", "sp")):
        got = sharding.sharded_prefix_prod(fq, mesh, axis)(sharding.shard_deck(mesh, a, (other, axis)))
        if not torch.equal(fq.from_mont(got), sharding.shard_deck(mesh, expect, (other, axis))):
            raise AssertionError(f"tier 1d: the prefix product with the sequence on {axis} differs from host bigints")
    progress("tier1d OK: prefix product with the sequence on sp and on dp equals host bigints")
    return shuffled


def tier2(mesh, m: int, n: int, keys, deck, shuffled, pi, rho, rand):
    """The staged prove + verify of this rank's `shard_batch` rows; returns
    the gathered proof and flags [B], every flag true."""
    cv = stark_curve()
    part = lambda t: sharding.shard_batch(mesh, t)
    proof = device_api.prove_shuffle(cv, m, n, keys, part(deck), part(shuffled), part(pi), part(rho), part(rand))
    checks = device_api.verify_shuffle(cv, m, n, keys, part(deck), part(shuffled), proof)
    proof, checks = sharding.gather_batch(mesh, proof), sharding.gather_batch(mesh, checks)
    flags = [bool(c.all()) for c in checks]
    if not all(flags):
        raise AssertionError(f"tier 2: sharded staged prove/verify failed: {dict(zip(checks._fields, flags))}")
    return proof, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="dry run of the port's parallel layer")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--inputs", default=None, help="a context saved by torch.save(build_context(...))")
    ap.add_argument("--out", default=None, help="rank 0 saves the gathered tier-2 proof here")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    t_start = time.perf_counter()
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(1)  # one CPU rank a core: the plain versions are chains of tiny ops
    init_distributed(dev)  # joins the launcher's group; on one process make_mesh starts its own
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_sp = 2 if world % 2 == 0 else 1
    mesh = global_mesh(n_sp, dev)
    rank = dist.get_rank()
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def progress(msg: str) -> None:
        print(f"[dryrun rank {rank} +{time.perf_counter() - t_start:6.1f}s] {msg}", flush=True)

    progress(f"start: {world} ranks on {args.device}, mesh dp={world // n_sp} x sp={n_sp}")
    if args.inputs:
        ctx = torch.load(args.inputs, map_location=dev, weights_only=False)  # a file this module's caller wrote
    else:
        ctx = build_context(batch=max(world, 2), device=dev)
    progress("context ready (tables, deck, permutations, scalars)")

    with torch.inference_mode():
        shuffled = tier1(mesh, ctx, progress)
        progress("tier2: staged prove starting (batch over dp x sp)")
        proof, checks = tier2(mesh, ctx["m"], ctx["n"], ctx["keys"], ctx["deck"], shuffled, ctx["pi"], ctx["rho"], ctx["rand"])
    flags = {f: bool(c.all()) for f, c in zip(checks._fields, checks)}
    progress(f"tier2 OK: staged prove+verify flags {flags}")
    if args.out and rank == 0:
        torch.save(proof, args.out)
    dist.destroy_process_group()
    print(f"dryrun OK rank={rank} on {world} ranks (mesh dp={world // n_sp} x sp={n_sp}): "
          f"tiers 1a-1d and 2, flags {flags}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
