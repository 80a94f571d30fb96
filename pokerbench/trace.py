"""One call traced by `torch.profiler`, read from the profiler's kineto
results (a walk over key_averages() takes tens of seconds for a call of
80,000 launches). The events stay in memory; no Chrome trace is written.

- device work: every device event that is not a `record_function` range;
- the port's five kernels, by their device-side names;
- busy seconds: the union of the device work's intervals;
- idle gaps: the stretches between device work inside the traced call,
  each put down to the innermost host event running at its start (or, in
  Python between events, to the event that follows).
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

import torch

# Device-side names of the port's kernels (`csrc/`), by the wrapper that
# launches them; the lane MSM at msm_nc = 1 launches the table kernel and
# the window/fold kernel.
KERNEL_FUNCTIONS = {
    "mont_mul": ("mont_mul_kernel",),
    "point_add": ("point_add_kernel",),
    "msm_lanes": ("msm_table_kernel", "msm_window_fold_kernel"),
    "fold_windows": ("fold_windows_kernel",),
    "msm_chunked": ("msm_chunked_window_kernel",),
}
KERNEL_NAMES = tuple(n for names in KERNEL_FUNCTIONS.values() for n in names)


class Span(NamedTuple):
    name: str
    start_us: float
    dur_us: float


class Trace(NamedTuple):
    device: list  # device work spans, by start
    host: list  # host spans, by start
    start_us: float  # the traced call's bounds on the trace's clock
    end_us: float

    def ops(self) -> int:
        return len(self.device)

    def device_ms(self, names=None) -> float:
        return sum(s.dur_us for s in self.device if names is None or any(n in s.name for n in names)) / 1e3

    def kernels_ms(self) -> float:
        return self.device_ms(KERNEL_NAMES)

    def others_ms(self) -> float:
        return self.device_ms() - self.kernels_ms()

    def busy_intervals(self) -> list:
        out = []
        for s in self.device:
            a, b = s.start_us, s.start_us + s.dur_us
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def window_s(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for s in self.device:
            by[s.name] = by.get(s.name, 0.0) + s.dur_us / 1e6
        return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle seconds of the traced call by the innermost host event
        running where each gap starts, the k largest."""
        starts = [h.start_us for h in self.host]
        by = {}
        edge = self.start_us
        for a, b in self.busy_intervals() + [[self.end_us, self.end_us]]:
            if a > edge:
                label = self._host_at(starts, edge)
                by[label] = by.get(label, 0.0) + (a - edge) / 1e6
            edge = max(edge, b)
        return sorted(([n, v] for n, v in by.items()), key=lambda r: -r[1])[:k]

    def _host_at(self, starts, t: float, scan: int = 4096) -> str:
        """The innermost host event running at t; where none runs (Python
        between operations), the next one to start."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - 1 - scan), -1):
            h = self.host[j]
            if h.start_us + h.dur_us >= t:
                return h.name
        return f"host between events, before {self.host[i].name}" if i < len(self.host) else "host after its last event"


def trace(fn) -> Trace:
    """fn() once under the profiler (host and device activity), synchronised."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        with torch.profiler.record_function("pokerbench traced call"):
            fn()
            torch.cuda.synchronize()
    device, host, bounds = [], [], None
    for ev in prof.profiler.kineto_results.events():
        span = Span(ev.name(), ev.start_ns() / 1e3, ev.duration_ns() / 1e3)
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append(span)
        elif span.name == "pokerbench traced call":
            bounds = span
        else:
            host.append(span)
    device.sort(key=lambda s: s.start_us)
    host.sort(key=lambda s: s.start_us)
    start = bounds.start_us if bounds else min(s.start_us for s in device)
    end = bounds.start_us + bounds.dur_us if bounds else max(s.start_us + s.dur_us for s in device)
    return Trace(device, host, start, end)
