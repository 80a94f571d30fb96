"""The benchmark of the PyTorch/CUDA port: one run of one cell.

    python3 -m pokerbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with an NVIDIA card. Every
piece is found by name from `BENCHMARK.json`: the cell's entry names its
configuration (`pokerbench/configs/<config>.json`, through the entry's
`file`) and its traffic (`pokerbench/workloads/<cell>.json`, whose
`driver` names a module of `pokerbench/drivers/`); each metric is read by
`pokerbench/metrics/<metric>.py`.

A run: set-up (the driver's inputs from the seed, the program's tables,
one warm call of every shape the window uses), the closed-loop window of
`--seconds`, the device's peak memory, with `--trace 1` one more call
under the profiler, then the comparison with the reference. The last line
of standard output is one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics, or with `--trace 1` its
per-layer ones), `device`, with `--trace 1` `breakdown`, `card` (the
card's name and power limit) and, last, `checks`: each number compared
with its limit. The same numbers end standard error.

The run exits with 2 and prints no result when there is no CUDA card (or
fewer than the cell asks for), when the program cannot be imported, or
when JAX or the JAX package was loaded into the process.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple


def _since_process_start() -> float:
    """Seconds since this process started (/proc), or 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _since_process_start()
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mental_poker_tpu")


class Run(NamedTuple):
    """What a metric reader reads."""

    unit: str  # the driver's request: "decks" or "games"
    setup_s: float
    window: object  # window.Window
    counters_start: dict  # the program's counters as the window opened
    counters_end: dict  # ... and after the run
    trace: object  # trace.Trace of one call (--trace 1), or None


def manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str, root: Path = ROOT):
    """(the cell's entry, its configuration, its traffic) by name."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"pokerbench: no workload {name!r} in BENCHMARK.json")
    conf_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(root / conf_entry["file"]) as f:
        conf = json.load(f)
    with open(root / "pokerbench" / "workloads" / f"{name}.json") as f:
        traffic = json.load(f)
    return wl, conf, traffic


def metrics_for(bench: dict, name: str, trace: bool) -> list:
    """The cell's metric entries: end-to-end without the trace, per-layer
    with it; an entry without `workloads` counts for every cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if name in m.get("workloads", [name])]


def reader(metric: str, root: Path = ROOT):
    path = root / "pokerbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"pokerbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device="cuda", root: Path = ROOT) -> dict:
    """One run of the cell on `device`; the result line as a dict."""
    import torch

    from . import window as window_mod
    from .trace import trace as trace_call

    bench = manifest(root)
    wl, conf, traffic = cell(bench, name, root)
    driver_mod = importlib.import_module(f"pokerbench.drivers.{traffic['driver']}")
    cuda = torch.device(device).type == "cuda"

    drv = driver_mod.Driver(conf, traffic, seed, device)
    drv.warm()
    setup_s = time.perf_counter() - T0
    start = drv.counters()
    win = window_mod.run(drv.call, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = trace_call(drv.trace_call) if trace else None
    run = Run(drv.unit, setup_s, win, start, drv.counters(), tr)

    metrics = {}
    for m in metrics_for(bench, name, trace):
        value = reader(m["name"], root)(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    t = time.perf_counter()
    checks = {k: {"value": v, "limit": lim} for k, (v, lim) in drv.checks().items()}
    print(f"# window {win.seconds:.3f} s, {len(win.calls)} calls; reference check {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    out = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": win.units,
        "failed": drv.failed(),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": wl["chips"],
            "memory_peak_bytes": peak,
        },
    }
    if tr is not None:
        out["device"].update(busy_s=tr.busy_s(), window_s=tr.window_s())
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    out["card"] = card_name() if cuda else "cpu"
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = manifest()
    wl = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if wl is None:
        print(f"pokerbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"pokerbench: needs {wl['chips']} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        importlib.import_module("mental_poker_tpu_torch")
    except ImportError as e:
        print(f"pokerbench: the program does not import: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"pokerbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 2
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
