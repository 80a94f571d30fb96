"""The trace's arithmetic on a made-up timeline (the profiler itself runs
only on the card)."""

import pytest

from pokerbench.trace import Span, Trace


def _trace():
    device = [Span("mont_mul_kernel<8>", 10, 5), Span("vectorized_elementwise_kernel", 12, 8),
              Span("point_add_kernel<8, 1>", 40, 10), Span("memcpy", 70, 5)]
    host = [Span("cudaGraphLaunch", 0, 30), Span("aten::copy_", 52, 10), Span("cudaStreamSynchronize", 76, 24)]
    return Trace(device, host, 0.0, 100.0)


def test_busy_is_the_union_of_device_intervals():
    tr = _trace()
    assert tr.busy_intervals() == [[10, 20], [40, 50], [70, 75]]
    assert tr.busy_s() == pytest.approx(25e-6)
    assert tr.window_s() == pytest.approx(100e-6)
    assert tr.ops() == 4


def test_kernel_and_other_device_time():
    tr = _trace()
    assert tr.kernels_ms() == pytest.approx(0.015)
    assert tr.others_ms() == pytest.approx(0.013)
    assert tr.top_ops(2) == [["point_add_kernel<8, 1>", pytest.approx(1e-5)], ["vectorized_elementwise_kernel", pytest.approx(8e-6)]]


def test_idle_gaps_by_host_event():
    """0-10 and 20-40 start inside the graph launch; 50-70 and 75-100 in
    Python between host events."""
    assert _trace().idle_gaps() == [
        ["cudaGraphLaunch", pytest.approx(30e-6)],
        ["host between events, before cudaStreamSynchronize", pytest.approx(25e-6)],
        ["host between events, before aten::copy_", pytest.approx(20e-6)],
    ]
