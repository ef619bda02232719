"""The port's profiling tool's trace arithmetic, on a synthetic chrome trace."""

import json

import pytest

pytest.importorskip("torch")
from equiformer_tpu_torch.tools.profile_eval import _union_us, trace_summary  # noqa: E402


@pytest.mark.parametrize("intervals, busy", [
    ([], 0.0),
    ([(0, 10), (20, 30)], 20.0),
    ([(0, 10), (5, 15), (12, 14)], 15.0),
    ([(5, 8), (0, 10)], 10.0),
])
def test_union_of_device_intervals(intervals, busy):
    assert _union_us(intervals) == busy


def test_trace_summary_per_forward(tmp_path):
    events = [
        {"cat": "kernel", "name": "dtp_lin_fwd_kernel", "ts": 0, "dur": 40},
        {"cat": "kernel", "name": "dtp_lin_fwd_kernel", "ts": 30, "dur": 20},
        {"cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 60, "dur": 10},
        {"cat": "kernel", "name": "attn_combine_kernel", "ts": 90, "dur": 10},
        {"cat": "cpu_op", "name": "aten::mm", "ts": 0, "dur": 500},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},  # no duration
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    s = trace_summary(path, n_forwards=2)
    assert s["device_busy_ms"] == pytest.approx(70e-3 / 2)  # 0-50, 60-70, 90-100
    assert s["launches"] == 1.5
    assert [k[0] for k in s["kernels"]] == ["dtp_lin_fwd_kernel", "attn_combine_kernel"]
    assert [v for k in s["kernels"] for v in k[1:]] == pytest.approx([30e-3, 1.0, 5e-3, 0.5])


def test_trace_without_device_events_raises(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [{"cat": "cpu_op", "ts": 0, "dur": 1}]}))
    with pytest.raises(RuntimeError):
        trace_summary(path, 1)


def test_trace_summary_sums_kernel_groups(tmp_path):
    """``kernel_groups`` sums the time and calls of every kernel whose name
    holds a group's pattern (K2's two launches apart, K3), per unit."""
    events = [
        {"cat": "kernel", "name": "void k2::dxdw_kernel<float, 6>(float const*)", "ts": 0,
         "dur": 30},
        {"cat": "kernel", "name": "void k2::dW_kernel<float, 6>(float const*)", "ts": 30,
         "dur": 20},
        {"cat": "kernel", "name": "void k2::dxdw_kernel<__nv_bfloat16, 6>(bf16 const*)",
         "ts": 50, "dur": 10},
        {"cat": "kernel", "name": "void csr_segment_sum_kernel<float, long long, 4>()",
         "ts": 60, "dur": 4},
        {"cat": "kernel", "name": "attn_combine_kernel", "ts": 70, "dur": 8},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    groups = trace_summary(path, n_forwards=2)["kernel_groups"]
    assert groups["k2::dxdw_kernel"] == pytest.approx([20e-3, 1.0])
    assert groups["k2::dW_kernel"] == pytest.approx([10e-3, 0.5])
    assert groups["csr_segment_sum_kernel"] == pytest.approx([2e-3, 0.5])
    assert groups["sum_partial_rows_kernel"] == [0.0, 0.0]
    assert groups["attn_combine_kernel"] == pytest.approx([4e-3, 0.5])


def test_trace_summary_sums_the_kernels_inside_a_range(tmp_path):
    """``annotated`` sums the kernels that ran on the card inside the spans
    of a ``record_function`` range (K4's backward), per unit."""
    from equiformer_tpu_torch.kernels.attn_csr import ATTN_BWD_RANGE

    events = [
        {"cat": "gpu_user_annotation", "name": ATTN_BWD_RANGE, "ts": 10, "dur": 20},
        {"cat": "gpu_user_annotation", "name": ATTN_BWD_RANGE, "ts": 100, "dur": 10},
        {"cat": "kernel", "name": "elementwise_kernel", "ts": 12, "dur": 5},
        {"cat": "kernel", "name": "index_kernel", "ts": 20, "dur": 8},
        {"cat": "kernel", "name": "reduce_kernel", "ts": 101, "dur": 3},
        {"cat": "kernel", "name": "attn_combine_kernel", "ts": 40, "dur": 8},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_summary(path, n_forwards=2)["annotated"][ATTN_BWD_RANGE] == pytest.approx(
        [8e-3, 1.5])
