"""Reading `torch.profiler` traces of the port: device time by kernel, the
device's busy time and idle share, device time by stage, and the top device
operations. The port's bench (`MPTPU_PROFILE`) and `chip_smoke.py` read
their traces here.

The device's events are read from the profiler's kineto results
(`device_spans`), not from key_averages(): that parses every CPU event into
a call tree, 33.6 s for one traced B=128 prove+verify (367,147 events) on
the host of an H100 machine.
"""

from __future__ import annotations

import bisect
import os
import time
from typing import NamedTuple

import torch

# Device-side kernel names (csrc/) of each wrapper's launches: msm_lanes at
# nc = 1 launches the table kernel and the window/fold kernel.
KERNEL_FUNCTIONS = {
    "mont_mul": ("mont_mul_kernel",),
    "point_add": ("point_add_kernel",),
    "msm_lanes": ("msm_table_kernel", "msm_window_fold_kernel"),
    "fold_windows": ("fold_windows_kernel",),
    "msm_chunked": ("msm_chunked_window_kernel",),
    "blake2s": ("blake2s_kernel",),
    "chacha_draw": ("chacha_draw_kernel",),
}


class Span(NamedTuple):
    """One event on the device's timeline."""

    name: str
    start_us: float
    dur_us: float
    annotation: bool  # a `record_function` range's span: no device work of its own


def device_spans(prof) -> list:
    """The device events of a finished `torch.profiler.profile`: kernels,
    copies and the spans of `record_function` ranges."""
    from torch.autograd import DeviceType

    return [Span(ev.name(), ev.start_ns() / 1e3, ev.duration_ns() / 1e3, ev.is_user_annotation())
            for ev in prof.profiler.kineto_results.events() if ev.device_type() == DeviceType.CUDA]


def _work(spans) -> list:
    return [s for s in spans if not s.annotation]


def device_ms(spans, names=None) -> float:
    """Device time (ms) of the kernels whose names contain one of `names`
    (all device work for None)."""
    return sum(s.dur_us for s in _work(spans) if names is None or any(n in s.name for n in names)) / 1e3


def kernel_device_ms(spans) -> dict:
    """Device time (ms) of one profiled run, summed over every launch, for
    each of the port's kernels (by its device-side names) and for all device
    work ("all")."""
    out = {k: device_ms(spans, names) for k, names in KERNEL_FUNCTIONS.items()}
    out["all"] = device_ms(spans)
    return out


def stage_device_ms(spans) -> dict:
    """Device time (ms) of each stage (`arguments/staged.py` with
    `stage_timing` on, each stage call a `record_function` range "stage
    <name>" ending in a synchronize): the kernels that start inside the
    range's span, summed over its calls. {name: [ms, calls]}."""
    work = sorted((s.start_us, s.dur_us) for s in _work(spans))
    starts = [w[0] for w in work]
    total = [0.0]
    for _, us in work:
        total.append(total[-1] + us)
    out = {}
    for s in spans:
        if s.annotation and s.name.startswith("stage "):
            i = bisect.bisect_left(starts, s.start_us)
            j = bisect.bisect_right(starts, s.start_us + s.dur_us)
            row = out.setdefault(s.name[len("stage "):], [0.0, 0])
            row[0] += (total[j] - total[i]) / 1e3
            row[1] += 1
    return out


def top_device_ops(spans, k: int = 10) -> list:
    """The k device operations with the most device time, by the names the
    profiler gives them: [(name, ms, launches)]."""
    by_name = {}
    for s in _work(spans):
        row = by_name.setdefault(s.name, [0.0, 0])
        row[0] += s.dur_us / 1e3
        row[1] += 1
    return sorted(((name, ms, n) for name, (ms, n) in by_name.items()), key=lambda r: -r[1])[:k]


def trace(fn, out_dir: str, name: str, device, k: int = 10) -> dict:
    """One call of fn() traced by torch.profiler (CPU activity, and CUDA's on
    a CUDA device, synchronised at the end), its Chrome trace written to
    `out_dir/name.json`. Returns the trace's path and the call's host
    seconds; on a CUDA device also the device-busy ms (all device work),
    the idle share of the traced call (1 - busy / wall; the profiler slows
    the call, so a caller with untraced runs reads busy against them), the
    device launches, the
    port's kernels' device ms, the top k device operations and, with
    `stage_timing` on, each stage's device ms (`stage_device_ms`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    path = os.path.join(out_dir, f"{name}.json")
    prof.export_chrome_trace(path)
    out = dict(trace=path, wall_s=wall_s)
    if cuda:
        spans = device_spans(prof)
        by_kernel = kernel_device_ms(spans)
        out.update(device_busy_ms=by_kernel["all"], idle_share_of_traced=1 - by_kernel["all"] / 1e3 / wall_s,
                   device_launches=len(_work(spans)), kernel_device_ms=by_kernel,
                   top_ops=top_device_ops(spans, k), stage_device_ms=stage_device_ms(spans))
    return out
