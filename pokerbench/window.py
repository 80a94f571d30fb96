"""The measured window and its arithmetic.

The window is a closed loop: the next call starts when the previous one
has returned and synchronised. It opens after set-up and closes at the
first call boundary after `seconds`. Every call carries `units` requests
(decks or games) that all complete when it returns, so each request's
latency is its call's. A rate is all the window's units over all its
seconds; a tail is the tail of all the window's requests.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple


class Call(NamedTuple):
    start_s: float  # since the window opened
    seconds: float
    units: int


class Window(NamedTuple):
    calls: list
    seconds: float  # from the open to the end of the last call

    @property
    def units(self) -> int:
        return sum(c.units for c in self.calls)

    def rate(self) -> float:
        return self.units / self.seconds

    def latencies_ms(self) -> list:
        return [c.seconds * 1e3 for c in self.calls for _ in range(c.units)]

    def percentile_ms(self, pct: float) -> float:
        """Nearest-rank percentile over every request of the window."""
        lat = sorted(self.latencies_ms())
        return lat[max(0, math.ceil(pct / 100 * len(lat)) - 1)]

    def mean_call_s(self) -> float:
        return sum(c.seconds for c in self.calls) / len(self.calls)


def run(call, seconds: float, clock=time.perf_counter) -> Window:
    """call(i) runs the i-th call to its synchronised end and returns its
    units; calls go on until `seconds` have passed."""
    calls = []
    t0 = clock()
    now = t0
    while now - t0 < seconds or not calls:
        start = now
        units = call(len(calls))
        now = clock()
        calls.append(Call(start - t0, now - start, units))
    return Window(calls, now - t0)
