"""The readers: rates and percentiles over the whole window, shares of the
card's peaks from counts and traced times, and the trace's reduction."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import counts, trace
from benchmark.cells import ROOT, load_cell, read_json
from benchmark.run import Run

H100 = "NVIDIA H100 80GB HBM3"
V8N = "yolov8n-640-bf16"


def make_run(name, readings, trace_summary=None, kind=H100, window_s=30.0, config=None):
    cell = load_cell(name)
    if config:
        cell.config = read_json(ROOT / "configs" / f"{config}.json")
    return Run(cell, 1, window_s, 12.5, readings, trace_summary, "card", kind)


def read(run, metric):
    return run.cell.metric(metric).read(run)


def test_sink_fps_and_latency_percentile_cover_the_whole_window():
    lat = np.full(24_000, 20.0)
    run = make_run("v8n-cams32", {"sink_events": 24_000, "latencies_ms": lat})
    assert read(run, "sink_fps") == 800.0
    assert read(run, "sat_frame_p99_ms.cams32") == 20.0
    # a stall early in the window: 400 frames at 900 ms; a deque of the last
    # 100 frames of each stream would never see it
    stalled = np.concatenate([np.full(400, 900.0), lat[400:]])
    run = make_run("v8n-cams32", {"sink_events": 24_000, "latencies_ms": stalled})
    assert read(run, "sat_frame_p99_ms.cams32") == 900.0
    assert read(run, "sink_fps") == 800.0
    assert read(run, "setup_s") == 12.5


def test_camera_counters_over_the_window():
    batcher = {"batches": 450, "frames": 14_400, "sum_batch_size": 14_400,
               "sum_infer_ms": 450 * 30.0, "sum_wait_ms": 14_400 * 5.0, "shed": 0}
    run = make_run("v8n-cams32", {"sink_events": 15_000, "reads": 15_360, "offered_fps": 800,
                                  "batcher": batcher, "max_batch": 32,
                                  "latencies_ms": np.arange(1.0, 101.0)})
    assert read(run, "read_share.cams32") == pytest.approx(64.0)
    assert read(run, "batch_fill.cams32") == pytest.approx(100.0)
    assert read(run, "service_ms.cams32") == pytest.approx(30.0)
    assert read(run, "sat_frame_p99_ms.cams32") == pytest.approx(99.01)
    want = 100 * 8742912000.0 * 15_000 / 30.0 / 989e12
    assert read(run, "mfu.cams32") == pytest.approx(want)
    empty = make_run("v8n-cams32", {"batcher": dict(batcher, batches=0, frames=0)})
    assert read(empty, "service_ms.cams32") is None


def _kernels(**launches):
    return {"kernels": {name: (secs, n) for name, (secs, n) in launches.items()},
            "busy_s": 1.5, "window_s": 3.0}


def test_rooflines_from_the_trace():
    t = _kernels(**{"void stem_mma_kernel<...>": (100 * 0.126e-3, 100),
                    "nms_mask_kernel(...)": (100 * 8.4e-6, 100),
                    "nms_chain_kernel(...)": (100 * 6.9e-6, 100)})
    run = make_run("v8l-footage-b32", {"batch": 32, "frames": 96_000}, t, config=V8N)
    flops, nbytes = counts.stem_work(32, 640, 640, 16, 32, 2)
    want = 100 * max(flops / 989e12, nbytes / 3.35e12) / 0.126e-3
    assert read(run, "stem_roofline") == pytest.approx(want)
    assert read(run, "nms_roofline") == pytest.approx(100 * 201_326_592 / 67e12 / 15.3e-6)
    assert read(run, "idle_share.footage") == pytest.approx(50.0)
    assert read(run, "mfu.footage") == pytest.approx(100 * 8742912000.0 * 3200 / 989e12)
    # no kernel of that name in the trace: nothing to read, never 0
    bare = make_run("v8l-footage-b32", {"batch": 32}, _kernels(gemm=(1.0, 10)))
    assert read(bare, "stem_roofline") is None and read(bare, "nms_roofline") is None
    # another card: no peak to share
    other = make_run("v8l-footage-b32", {"batch": 32, "frames": 10}, t, kind="other card",
                     config=V8N)
    assert read(other, "stem_roofline") is None and read(other, "mfu.footage") is None
    untraced = make_run("v8l-footage-b32", {"batch": 32}, None)
    assert read(untraced, "idle_share.footage") is None


def test_trace_summary_merges_busy_time_and_labels_idle_gaps():
    dev = [("k1", 0.0, 10.0), ("k2", 5.0, 20.0), ("k1", 40.0, 50.0), ("copy", 90.0, 100.0)]
    host = [("cudaGraphLaunch", 18.0, 45.0), ("aten::copy_", 25.0, 26.0),
            ("cudaStreamSynchronize", 60.0, 95.0)]
    s = trace.summarize(dev, host)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["kernels"]["k1"] == (pytest.approx(20e-6), 2)
    gaps = dict((n, v) for n, v in s["breakdown"]["idle_gaps"])
    assert gaps == {"cudaGraphLaunch": pytest.approx(20e-6),
                    "cudaStreamSynchronize": pytest.approx(40e-6)}
    assert s["breakdown"]["device_ops"][0] == ["k1", pytest.approx(20e-6)]
    assert trace.summarize([], host) == {}


def test_trace_rows_stop_at_the_mark():
    from types import SimpleNamespace

    from torch.autograd import DeviceType

    def event(name, start, end, device=DeviceType.CPU):
        return SimpleNamespace(name=name, time_range=SimpleNamespace(start=start, end=end),
                               device_type=device)

    events = [event("k1", 0.0, 10.0, DeviceType.CUDA), event("k2", 40.0, 70.0, DeviceType.CUDA),
              event("aten::mm", 5.0, 8.0), event(trace.MARK, 50.0, 50.1),
              event("k3", 60.0, 80.0, DeviceType.CUDA), event("aten::relu", 55.0, 56.0)]
    dev, host = trace.rows(events)
    assert dev == [("k1", 0.0, 10.0), ("k2", 40.0, 50.0)]
    assert host == [("aten::mm", 5.0, 8.0)]
    unmarked = [e for e in events if e.name != trace.MARK]
    assert len(trace.rows(unmarked)[0]) == 3
