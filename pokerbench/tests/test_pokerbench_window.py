"""The window's rate and tail arithmetic."""

import pytest

from pokerbench import window


class Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _window(durations, units, seconds):
    clock = Clock()
    it = iter(durations)

    def call(i):
        clock.t += next(it)
        return units

    return window.run(call, seconds, clock)


def test_rate_is_all_units_over_all_seconds():
    w = _window([0.5] * 40, 1024, 10.0)
    assert len(w.calls) == 20 and w.seconds == pytest.approx(10.0)
    assert w.rate() == pytest.approx(20 * 1024 / 10.0)


def test_window_closes_at_the_first_boundary_after_its_seconds():
    w = _window([0.3] * 100, 1, 1.0)
    assert len(w.calls) == 4 and w.seconds == pytest.approx(1.2)


def test_a_stall_moves_rate_and_tail():
    steady = _window([0.2] * 400, 1, 40.0)
    stalled = _window([0.2] * 100 + [3.0] * 10 + [0.2] * 400, 1, 40.0)
    assert len(stalled.calls) == 107  # the window closes on the seventh stall, at 41 s
    assert steady.percentile_ms(95) == pytest.approx(200.0)
    assert stalled.percentile_ms(95) == pytest.approx(3000.0)  # 7 of 107 requests lie above the 95th rank
    assert stalled.percentile_ms(50) == pytest.approx(200.0)
    assert stalled.rate() < 0.8 * steady.rate()


def test_tail_counts_each_request_of_a_batch():
    w = _window([1.0, 2.0], 3, 1.5)
    assert w.latencies_ms() == [1000.0] * 3 + [2000.0] * 3
    assert w.percentile_ms(50) == 1000.0 and w.percentile_ms(95) == 2000.0
    assert w.mean_call_s() == pytest.approx(1.5)
