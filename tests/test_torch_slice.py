"""The port's slice as a whole, on the CPU.

1. The golden trajectory: every frame of data/samples/demo.mp4 through the
   port's own ``InferenceBatcher`` -> ``TorchYoloEngine`` -> ``IouTracker``
   exactly as scripts/gen_golden_trajectory.py::run_trajectory drives the
   JAX chain (two phase-shifted streams sharing one batcher; 320 input,
   fp32, bucket [2], the mean2 device-resize step), held against the
   committed tests/data/golden_trajectory.json with the tolerances of
   tests/test_golden_trajectory.py: ids, classes, age and hits exact, conf
   atol 6e-3, boxes atol 0.75. The weights are the same synthetic yolov8n
   state dict, carried as a flat .npz.
2. A short ``AnalyticsPipeline.run_for`` with two synthetic streams: frames
   flow on both and the pipeline shuts down cleanly.
3. The YOLO device-resize step (no host pick, no host resize) at a
   fractional source geometry (300x400 -> 128: 96x128 content) against
   ``JaxYoloEngine``: with ``pallas_preprocess`` auto both run their plain
   letterbox; with ``on`` the JAX package runs its Pallas kernel in
   interpret mode and the port B4's CPU form. Bounds as the engine test
   (tests/test_torch_engine.py): num_valid and classes equal, boxes atol
   1e-2 px, scores atol 1e-4.
4. ``AnalyticsPipeline`` serving the ResNet classifier and a temporal
   model: frames flow, and the temporal branches publish clip metrics.
"""

import asyncio
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.engine.detector import JaxYoloEngine
from realtime_analytics_tpu_torch.config import (
    DetectorConfig,
    KafkaSinkConfig,
    PipelineConfig,
    PrometheusConfig,
    SnapshotConfig,
    StreamConfig,
    TrackerConfig,
)
from realtime_analytics_tpu_torch.engine.batcher import InferenceBatcher
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
from realtime_analytics_tpu_torch.ops.letterbox import letterbox_plain
from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec, preprocess_batch
from realtime_analytics_tpu_torch.pipeline import AnalyticsPipeline
from realtime_analytics_tpu_torch.tracker import IouTracker
from realtime_analytics_tpu_torch.types import FramePacket

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "data", "golden_trajectory.json")


def _script(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_trajectory(engine, frames, offset):
    """scripts/gen_golden_trajectory.py::run_trajectory on the port's own
    batcher and tracker."""
    n = len(frames)
    streams = {name: StreamConfig(name=name, url=f"file://demo-{name[-1]}")
               for name in ("cam-a", "cam-b")}
    tracker = IouTracker(TrackerConfig())
    records = {name: [] for name in streams}

    async def drive():
        batcher = InferenceBatcher(engine, max_batch=2, batch_window_ms=30.0)
        await batcher.start()
        try:
            for i in range(n):
                futs = {}
                for name, off in (("cam-a", 0), ("cam-b", offset)):
                    pkt = FramePacket(stream=streams[name], frame=frames[(i + off) % n],
                                      frame_id=i, timestamp=i / 25.0)
                    futs[name] = batcher.submit_nowait(pkt)
                for name in ("cam-a", "cam-b"):
                    dets = await futs[name]
                    tracks = tracker.update(name, dets or [])
                    records[name].append(sorted(
                        ({"id": int(t.track_id), "cls": int(t.class_id),
                          "conf": round(float(t.confidence), 4),
                          "box": [round(float(v), 2) for v in t.bbox_xyxy],
                          "age": int(t.age), "hits": int(t.hits)} for t in tracks),
                        key=lambda r: r["id"],
                    ))
        finally:
            await batcher.stop()

    asyncio.run(drive())
    return records


def test_golden_trajectory_through_the_port(tmp_path):
    with open(GOLDEN) as f:
        want = json.load(f)
    weights = tmp_path / "yolov8n_synthetic.npz"
    np.savez(weights, **_script("gen_golden_fixture").synthetic_weights())
    engine = TorchYoloEngine(DetectorConfig(
        model_path=str(weights), model_type="yolov8", device="cpu",
        confidence_threshold=0.25, iou_threshold=0.45, input_size=[320, 320],
        max_batch_size=2, batch_buckets=[2], max_detections=100,
        pre_nms_topk=256, precision="fp32", warmup=False,
    ))
    frames = _script("gen_golden_trajectory").load_frames()
    _, selected = engine.host_prepare(frames[0][None], frames[0].shape[:2])
    assert not selected  # 640x360 -> 320: the mean2 device-resize step
    got = _run_trajectory(engine, frames, want["stream_b_offset"])
    for name in ("cam-a", "cam-b"):
        g_steps, w_steps = got[name], want["steps"][name]
        assert len(g_steps) == len(w_steps) == want["n_steps"]
        for i, (g, w) in enumerate(zip(g_steps, w_steps)):
            ctx = f"{name} step {i}"
            assert [t["id"] for t in g] == [t["id"] for t in w], ctx
            assert [t["cls"] for t in g] == [t["cls"] for t in w], ctx
            assert [t["age"] for t in g] == [t["age"] for t in w], ctx
            assert [t["hits"] for t in g] == [t["hits"] for t in w], ctx
            np.testing.assert_allclose([t["conf"] for t in g], [t["conf"] for t in w],
                                       atol=6e-3, err_msg=ctx)
            np.testing.assert_allclose([t["box"] for t in g], [t["box"] for t in w],
                                       atol=0.75, err_msg=ctx)


def test_cli_runs_the_repo_sim_config(tmp_path):
    """The port's entry point reads the repo's own pipeline YAML (the one
    the JAX package reads), here cut to the CPU and a small input."""
    import yaml

    from realtime_analytics_tpu_torch.scripts import run_pipeline

    with open(os.path.join(REPO, "config", "pipeline-sim.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["detector"].update(device="cpu", input_size=[128, 128], precision="fp32",
                           model_path=str(tmp_path / "absent.pt"))
    path = tmp_path / "sim.yaml"
    path.write_text(yaml.safe_dump(raw))
    assert run_pipeline.main(["--config", str(path), "--duration", "1.5",
                              "--log-level", "WARNING"]) == 0


def test_pipeline_runs_two_synthetic_streams_and_stops():
    cfg = PipelineConfig(
        streams=[
            StreamConfig(name=f"cam-{i}", url=f"synthetic://?width=160&height=120&seed={i}",
                         warmup_seconds=0.0, target_fps=25, batch_size=2)
            for i in range(2)
        ],
        detector=DetectorConfig(
            model_path="__random__.pt", device="cpu", confidence_threshold=0.005,
            warmup=True, input_size=[128, 128], max_batch_size=2,
            batch_buckets=[2], pre_nms_topk=128, precision="fp32",
        ),
        tracker=TrackerConfig(min_hits=1),
        kafka=KafkaSinkConfig(enabled=True, transport="memory"),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        stats_interval_seconds=30,
    )
    pipeline = AnalyticsPipeline(cfg)
    asyncio.run(pipeline.run_for(2.0))
    assert {p["stream"] for p in pipeline.kafka.memory_buffer} == {"cam-0", "cam-1"}
    assert all(w.health.total_frames > 0 for w in pipeline.workers)
    assert pipeline.batchers["__default__"].stats.frames > 0
    assert not pipeline._tasks  # stop() reaped every task


@pytest.mark.parametrize("pallas_preprocess", ["auto", "on"])
def test_device_resize_step_matches_jax(tmp_path, pallas_preprocess):
    weights = tmp_path / "yolov8n_synthetic.npz"
    np.savez(weights, **_script("gen_golden_fixture").synthetic_weights())
    kw = dict(model_path=str(weights), device="cpu", confidence_threshold=0.25,
              warmup=False, input_size=[128, 128], max_batch_size=4, batch_buckets=[4],
              pre_nms_topk=256, precision="fp32", host_select="off", host_resize="off",
              pallas_preprocess=pallas_preprocess)
    scene = cv2.imread(os.path.join(REPO, "tests", "data", "golden_scene.png"))
    frames = np.stack([scene[y:y + 300, x:x + 400]
                       for y, x in ((300, 100), (500, 700), (600, 1200), (200, 1500))])
    engine = TorchYoloEngine(DetectorConfig(**kw))
    _, selected = engine.host_prepare(frames, frames.shape[1:3])
    assert not selected  # the device-resize step
    # on the CPU, auto takes the plain preprocess as the JAX package's auto
    # does off the TPU; on takes B4's CPU form
    spec = letterbox_spec(frames.shape[1:3], engine.input_hw)
    x = torch.from_numpy(frames)
    plain = (letterbox_plain(x, spec, torch.float32) if pallas_preprocess == "on" else
             preprocess_batch(x, spec=spec, out_dtype=torch.float32, layout="NHWC"))
    assert torch.equal(engine._device_letterbox(x, spec), plain)
    want = JaxYoloEngine(JaxConfig(**kw)).predict_arrays(frames)
    got = engine.predict_arrays(frames)
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    assert want.num_valid.min() >= 10
    for i, n in enumerate(want.num_valid):
        np.testing.assert_array_equal(got.class_ids[i, :n], want.class_ids[i, :n])
        np.testing.assert_allclose(got.boxes_xyxy[i, :n], want.boxes_xyxy[i, :n], atol=1e-2)
        np.testing.assert_allclose(got.scores[i, :n], want.scores[i, :n], atol=1e-4)


@pytest.mark.parametrize("model_type", ["resnet", "cnn_lstm"])
def test_pipeline_serves_classifier_and_temporal_models(monkeypatch, model_type):
    from realtime_analytics_tpu_torch.telemetry.metrics import MetricsPublisher

    calls = []
    monkeypatch.setattr(MetricsPublisher, "update_temporal_metrics",
                        lambda self, stream, **kw: calls.append((stream, kw)))
    cfg = PipelineConfig(
        streams=[
            StreamConfig(name=f"cam-{i}", url=f"synthetic://?width=160&height=120&seed={i}",
                         warmup_seconds=0.0, target_fps=25, batch_size=2)
            for i in range(2)
        ],
        detector=DetectorConfig(
            model_path=f"absent-{model_type}18.pt", model_type=model_type, device="cpu",
            confidence_threshold=0.01, warmup=True, input_size=[32, 32], max_batch_size=2,
            batch_buckets=[2], precision="fp32", resnet_num_classes=10,
            num_action_classes=10, sequence_length=4,
        ),
        tracker=TrackerConfig(min_hits=1),
        kafka=KafkaSinkConfig(enabled=True, transport="memory"),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        stats_interval_seconds=30,
    )
    pipeline = AnalyticsPipeline(cfg)
    asyncio.run(pipeline.run_for(2.0))
    assert all(w.health.total_frames > 0 for w in pipeline.workers)
    assert {p["stream"] for p in pipeline.kafka.memory_buffer} == {"cam-0", "cam-1"}
    if model_type == "resnet":
        assert not calls
    else:  # one call per finished frame; clips every 2 frames once 4 are in
        assert {c[0] for c in calls} == {"cam-0", "cam-1"}
        assert any(kw["sequences"] == 1 for _, kw in calls)
        assert all(0 < kw["buffer_size"] <= 4 for _, kw in calls)
