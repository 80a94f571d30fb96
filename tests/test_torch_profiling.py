"""The port's trace readers (`mental_poker_tpu_torch/profiling.py`) on
synthetic device spans (microseconds), and one traced call on the CPU.

- `kernel_device_ms`: each of the port's kernels sums the launches of its
  device-side names (template arguments and all) and no other kernel's;
  "all" sums every kernel and copy; the spans of `record_function` ranges
  count nowhere.
- `stage_device_ms`: a stage's device time is that of the kernels that
  start inside its range's span, ends included, summed over its calls;
  ranges not named "stage ..." are not stages, and work between two
  stages counts in neither.
- `device_ms` filters by name; `top_device_ops` keeps the k largest.
- `trace` on the CPU writes the Chrome trace and reports no device keys.

Tolerance: `pytest.approx` on sums of microseconds.
"""

import json

import pytest
import torch

from mental_poker_tpu_torch import profiling
from mental_poker_tpu_torch.profiling import KERNEL_FUNCTIONS, Span


@pytest.mark.parametrize("kernel", sorted(KERNEL_FUNCTIONS))
def test_kernel_device_ms_by_device_name(kernel):
    spans = [Span("stage stmt", 0, 1000, True), Span("Memcpy HtoD (Pageable -> Device)", 900, 3, False)]
    start = 0
    for other, names in sorted(KERNEL_FUNCTIONS.items()):
        for j, name in enumerate(names):
            us = 10.0 * (j + 1) if other == kernel else 1.0
            spans.append(Span(f"void {name}<8, 1>(int const*, int*)", start, us, False))
            start += 20
    got = profiling.kernel_device_ms(spans)
    n_names = len(KERNEL_FUNCTIONS[kernel])
    assert got[kernel] == pytest.approx(sum(10.0 * (j + 1) for j in range(n_names)) / 1e3)
    others = sum(len(v) for k, v in KERNEL_FUNCTIONS.items() if k != kernel)
    assert got["all"] == pytest.approx((sum(10.0 * (j + 1) for j in range(n_names)) + others + 3) / 1e3)
    assert all(got[k] == pytest.approx(len(v) / 1e3) for k, v in KERNEL_FUNCTIONS.items() if k != kernel)


STAGE_CASES = {
    "no_stage_range": ([Span("mont_mul_kernel", 5, 4, False)], {}),
    "kernel_started_before_range": (
        [Span("stage commit", 10, 20, True), Span("point_add_kernel", 5, 10, False),
         Span("point_add_kernel", 12, 3, False)],
        {"commit": [pytest.approx(0.003), 1]},
    ),
    "range_ends_included": (
        [Span("stage combo", 100, 50, True), Span("msm_table_kernel", 100, 7, False),
         Span("msm_window_fold_kernel", 150, 2, False), Span("msm_window_fold_kernel", 151, 40, False)],
        {"combo": [pytest.approx(0.009), 1]},
    ),
    "other_ranges_and_calls": (
        [Span("prove", 0, 500, True), Span("stage flags", 0, 10, True), Span("add", 1, 1, False),
         Span("stage flags", 100, 10, True), Span("add", 105, 2, False), Span("stage make_a", 200, 5, True)],
        {"flags": [pytest.approx(0.003), 2], "make_a": [0.0, 1]},
    ),
    "work_between_stages": (
        [Span("stage stmt", 0, 100, True), Span("mont_mul_kernel<8>", 10, 20, False), Span("add", 40, 5, False),
         Span("between stages", 150, 10, False),
         Span("stage commit", 200, 100, True), Span("point_add_kernel<8, 1>", 250, 10, False),
         Span("stage commit", 400, 10, True), Span("add", 400, 2, False)],
        {"stmt": [pytest.approx(0.025), 1], "commit": [pytest.approx(0.012), 2]},
    ),
}


@pytest.mark.parametrize("spans,want", list(STAGE_CASES.values()), ids=list(STAGE_CASES))
def test_stage_device_ms_cases(spans, want):
    assert profiling.stage_device_ms(spans) == want


def test_device_ms_name_filter():
    spans = [Span("mont_mul_kernel<8>", 0, 4, False), Span("point_add_kernel<8, 1>", 10, 6, False),
             Span("Memset (Device)", 20, 1, False), Span("stage stmt", 0, 30, True)]
    assert profiling.device_ms(spans) == pytest.approx(0.011)
    assert profiling.device_ms(spans, ("mont_mul",)) == pytest.approx(0.004)
    assert profiling.device_ms(spans, ("mont_mul", "point_add")) == pytest.approx(0.010)
    assert profiling.device_ms(spans, ("fold_windows",)) == 0


def test_top_device_ops_k():
    spans = [Span(f"op{i % 4}", i, float(i % 4 + 1), False) for i in range(12)] + [Span("stage x", 0, 99, True)]
    top = profiling.top_device_ops(spans, 2)
    assert top == [("op3", pytest.approx(0.012), 3), ("op2", pytest.approx(0.009), 3)]
    assert [name for name, _, _ in profiling.top_device_ops(spans)] == ["op3", "op2", "op1", "op0"]


def test_trace_on_cpu_writes_chrome_trace(tmp_path):
    calls = []
    out = profiling.trace(lambda: calls.append(int(torch.arange(8).sum())), str(tmp_path / "t"), "one", "cpu")
    assert calls == [28]
    assert sorted(out) == ["trace", "wall_s"] and out["wall_s"] > 0
    assert out["trace"] == str(tmp_path / "t" / "one.json")
    assert json.loads((tmp_path / "t" / "one.json").read_text())["traceEvents"]


def test_empty_trace_reads_zero():
    assert profiling.kernel_device_ms([]) == {**{k: 0 for k in KERNEL_FUNCTIONS}, "all": 0}
    assert profiling.stage_device_ms([]) == {} and profiling.top_device_ops([]) == []
