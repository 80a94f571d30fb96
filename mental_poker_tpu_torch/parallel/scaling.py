"""DP scaling curve of the staged prove+verify (counterpart of
`scripts/scaling_curve.py`).

    python -m mental_poker_tpu_torch.parallel.scaling [--m 2 --n 4] [--device cuda|cpu] [--out FILE]
    python -m torch.distributed.run --nproc_per_node=W -m mental_poker_tpu_torch.parallel.scaling [...]

A fixed total batch of B decks (`MPTPU_SCALING_B`, default 8) at (m, n)
(default (2, 4)) is proved and verified for each dp in (1, 2, 4, 8) with
dp at most the world size W: the first dp ranks form a (dp, 1) mesh, each
proves and verifies its `shard_batch` rows, and `gather_batch` brings the
proofs and flags back; every flag must be true. One warm run, then
`MPTPU_SCALING_REPS` (default 3) timed runs, host clock to the gathered
flags. Rank 0 prints one JSON line a dp, `{"dp", "total_B", "wall_s",
"pairs_per_s", "overhead_vs_dp1"}` (`wall_s` the mean run), then a line
naming the dp it could not run for want of ranks, then the summary line
`dp_scaling_overhead`. With `--out FILE` rank 0 saves each dp's gathered
proof there (`torch.save`, a dict dp -> proof).

One process per card on "cuda" (NCCL; one card gives dp = 1 alone), or per
CPU process on "cpu" (gloo). Ranks past dp wait for the next dp.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from ..ops.curve import stark_curve
from ..ops.msm import FixedBaseTable
from . import dryrun, sharding

DPS = (1, 2, 4, 8)


def dp_mesh(dp: int, device):
    """The (dp, 1) mesh of ranks 0..dp-1 (every rank of the group calls it)."""
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(torch.device(device).type, torch.arange(dp).reshape(dp, 1), mesh_dim_names=sharding.DIMS)


def scaling_curve(m: int, n: int, B: int, reps: int, device="cuda", out=print) -> tuple:
    """The curve on the process group (`sharding.make_mesh` joins or starts
    it): for each dp of `DPS` up to the world size, the first dp ranks
    prove and verify B decks at (m, n) on the Stark curve
    (`dryrun.build_context`). Rank 0 calls `out` with each line. Returns
    (rows, proofs by dp, dp not run); ranks past a dp hold no row or proof
    for it."""
    import torch.distributed as dist

    dev = torch.device(device)
    sharding.make_mesh(device=dev)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    rank, world = dist.get_rank(), dist.get_world_size()
    ctx = dryrun.build_context(m, n, B, seed=4242, device=dev)
    cv = stark_curve()
    gen, pk = (FixedBaseTable(cv, None, table=t) for t in (ctx["keys"].gen, ctx["keys"].pk))
    shuffled = sharding.remask_shuffled_step(cv, gen, pk)(ctx["deck"], ctx["pi"], ctx["rho"])
    rows, proofs, base = [], {}, None
    for dp in (d for d in DPS if d <= world):
        mesh = dp_mesh(dp, dev)
        if rank >= dp:
            continue

        def one():
            return dryrun.tier2(mesh, m, n, ctx["keys"], ctx["deck"], shuffled, ctx["pi"], ctx["rho"],
                                ctx["rand"])

        one()  # warm
        t0 = time.perf_counter()
        for _ in range(reps):
            proof, _ = one()  # raises unless every gathered flag is true
        wall = (time.perf_counter() - t0) / reps
        base = wall if base is None else base
        row = {"dp": dp, "total_B": B, "wall_s": wall, "pairs_per_s": B / wall, "overhead_vs_dp1": wall / base - 1.0}
        rows.append(row)
        proofs[dp] = proof
        if rank == 0:
            out(json.dumps(row))
    missing = [d for d in DPS if d > world]
    if rank == 0:
        if missing:
            out(json.dumps({"not_run_dp": missing, "reason": f"world size {world} < dp"}))
        out(json.dumps({
            "metric": "dp_scaling_overhead",
            "note": f"fixed total B = {B} split over the first dp ranks (shard_batch, gather_batch) on {dev.type}; "
                    "overhead ~0 => the DP path adds no cost beyond its gather",
            "max_overhead": max(r["overhead_vs_dp1"] for r in rows),
        }))
    return rows, proofs, missing


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="DP scaling curve of the staged prove+verify")
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--n", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=None, help="rank 0 saves each dp's gathered proof here")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    B = int(os.environ.get("MPTPU_SCALING_B") or 8)
    reps = int(os.environ.get("MPTPU_SCALING_REPS") or 3)
    if args.device == "cpu":
        torch.set_num_threads(1)  # one CPU rank a core: the plain versions are chains of tiny ops
    with torch.inference_mode():
        _, proofs, _ = scaling_curve(args.m, args.n, B, reps, args.device, out=lambda line: print(line, flush=True))
    if args.out and dist.get_rank() == 0:
        torch.save(proofs, args.out)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
