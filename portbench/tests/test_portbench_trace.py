"""The reading of a profiler trace: device spans merged per card inside
the scan's span, idle gaps named by the host scope open over them."""

import json

import pytest

from portbench import run, trace


def _trace_file(tmp_path):
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.SCAN_SPAN,
         "ts": 0, "dur": 1000},
        {"ph": "X", "cat": "user_annotation", "name": "device.feed",
         "ts": 0, "dur": 700},
        {"ph": "X", "cat": "user_annotation", "name": "host.assemble",
         "ts": 400, "dur": 300},
        {"ph": "X", "cat": "user_annotation", "name": "host.emit",
         "ts": 700, "dur": 300},
        {"ph": "X", "cat": "kernel", "name": "swar_counts_kernel(int)",
         "ts": 50, "dur": 100, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "orbit_kernel(int)",
         "ts": 100, "dur": 100, "args": {"device": 0}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 300, "dur": 100, "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "swar_counts_kernel(int)",
         "ts": 50, "dur": 400, "args": {"device": 1}},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 1500, "dur": 10,
         "args": {"device": 0}},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return str(path)


def test_busy_idle_and_breakdown(tmp_path):
    ev = trace.load(_trace_file(tmp_path))
    assert ev["span"] == (0.0, 1000.0)
    assert trace.busy_intervals(ev, 0) == [(50.0, 200.0), (300.0, 400.0)]
    assert trace.busy_seconds(ev, 0) == pytest.approx(250e-6)
    assert trace.window_seconds(ev) == pytest.approx(1e-3)
    summary = trace.device_summary(ev, [0, 1])
    assert summary["busy_s"] == pytest.approx((250e-6 + 400e-6) / 2)
    assert trace.kernel_seconds(ev, "swar_counts_kernel") == \
        pytest.approx(500e-6)
    b = trace.breakdown(ev)
    assert b["device_ops"][0] == ["swar_counts_kernel(int)",
                                  pytest.approx(500e-6)]
    gaps = dict(b["idle_gaps"])
    # card 0 idles 0-50 and 200-300 under device.feed, 400-700 under
    # host.assemble, 700-1000 under host.emit
    assert gaps["device.feed"] == pytest.approx(150e-6)
    assert gaps["host.assemble"] == pytest.approx(300e-6)
    assert gaps["host.emit"] == pytest.approx(300e-6)
    ctx = run.MetricContext.__new__(run.MetricContext)
    ctx.events, ctx.devices = ev, [0, 1]
    idle = run.metric_reader("device.idle_pct")(ctx)
    assert idle == pytest.approx(75.0)


def test_no_trace_reads_nothing():
    assert trace.device_summary(None, [0]) == {}
    assert trace.breakdown(None) == {"device_ops": [], "idle_gaps": []}
    ctx = run.MetricContext.__new__(run.MetricContext)
    ctx.events, ctx.devices = None, [0]
    assert run.metric_reader("device.idle_pct")(ctx) is None
