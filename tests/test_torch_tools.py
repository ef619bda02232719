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
