"""The port's dp scaling curve (`mental_poker_tpu_torch/parallel/scaling.py`,
the counterpart of `scripts/scaling_curve.py`) on the CPU.

Two gloo processes (torchrun's environment set by hand), total B = 2 decks
at (2, 4), `MPTPU_SCALING_REPS=1`: rank 0 prints the dp = 1 and dp = 2 rows,
names dp 4 and 8 as not run, and ends with the summary line; every gathered
flag is true (the ranks raise otherwise); the dp = 2 proof, gathered from
the two ranks' B = 1 proofs, equals the dp = 1 proof leaf for leaf. At
world size 1, in this process, the lines a one-card run prints.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

import pytest
import torch

from mental_poker_tpu_torch.parallel.sharding import leaves

REPO = str(pathlib.Path(__file__).resolve().parents[1])


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_dp1_dp2(tmp_path):
    out = str(tmp_path / "proofs.pt")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               OMP_NUM_THREADS="1", MPTPU_SCALING_B="2", MPTPU_SCALING_REPS="1")
    cmd = [sys.executable, "-m", "mental_poker_tpu_torch.parallel.scaling", "--device", "cpu", "--out", out]
    procs = [subprocess.Popen(cmd, cwd=REPO, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("a scaling process timed out\n" + "\n---\n".join(outs))
    for r, (p, text) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{text}"
    lines = [json.loads(line) for line in outs[0].splitlines() if line.startswith("{")]
    assert not [line for line in outs[1].splitlines() if line.startswith("{")]  # rank 0 alone prints
    rows = [line for line in lines if "dp" in line]
    assert [(r["dp"], r["total_B"]) for r in rows] == [(1, 2), (2, 2)]
    assert rows[0]["overhead_vs_dp1"] == 0.0 and all(r["wall_s"] > 0 and r["pairs_per_s"] > 0 for r in rows)
    assert [line["not_run_dp"] for line in lines if "not_run_dp" in line] == [[4, 8]]
    assert lines[-1]["metric"] == "dp_scaling_overhead"
    assert lines[-1]["max_overhead"] == max(r["overhead_vs_dp1"] for r in rows)
    proofs = torch.load(out, weights_only=False)
    assert sorted(proofs) == [1, 2]
    assert len(leaves(proofs[1])) == len(leaves(proofs[2])) == 56
    assert all(torch.equal(a, b) for a, b in zip(leaves(proofs[1]), leaves(proofs[2])))


def test_one_rank_lines(monkeypatch):
    """At world size 1 (one card) rank 0 runs dp = 1 alone, with a warm run
    and `reps` timed ones, names 2, 4 and 8 as not run and ends with the
    summary line; the prove+verify (`dryrun.tier2`, held against the
    unsharded flow in `test_torch_parallel.py`) stands in here by a stub."""
    import torch.distributed as dist

    from mental_poker_tpu_torch.parallel import dryrun, scaling, sharding

    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    built, calls = [], []
    ctx = dict(keys=type("Keys", (), {"gen": "gen", "pk": "pk"}), deck="deck", pi="pi", rho="rho", rand="rand")
    monkeypatch.setattr(dryrun, "build_context", lambda *a, **kw: built.append((a, kw)) or ctx)
    monkeypatch.setattr(scaling, "FixedBaseTable", lambda cv, c, table: table)
    monkeypatch.setattr(sharding, "remask_shuffled_step", lambda cv, gen, pk: lambda deck, pi, rho: "shuffled")
    monkeypatch.setattr(dryrun, "tier2", lambda mesh, *args: calls.append((mesh.shape, args)) or ("proof", "flags"))
    lines = []
    try:
        rows, proofs, missing = scaling.scaling_curve(2, 4, 3, 2, "cpu", out=lines.append)
    finally:
        dist.destroy_process_group()
    assert built == [((2, 4, 3), {"seed": 4242, "device": torch.device("cpu")})]
    assert calls == [((1, 1), (2, 4, ctx["keys"], "deck", "shuffled", "pi", "rho", "rand"))] * 3
    assert proofs == {1: "proof"} and missing == [2, 4, 8]
    lines = [json.loads(line) for line in lines]
    assert [(r["dp"], r["total_B"], r["overhead_vs_dp1"]) for r in rows] == [(1, 3, 0.0)] and lines[0] == rows[0]
    assert rows[0]["pairs_per_s"] == pytest.approx(3 / rows[0]["wall_s"])
    assert lines[1] == {"not_run_dp": [2, 4, 8], "reason": "world size 1 < dp"}
    assert lines[2]["metric"] == "dp_scaling_overhead" and lines[2]["max_overhead"] == 0.0 and len(lines) == 3
