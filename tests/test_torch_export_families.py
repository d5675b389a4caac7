"""The port's serving artifacts on the CPU: ResNet, temporal, graph-backed.

Each exported engine serves results bit-identical to the live engine it
was exported from (tests/test_torch_export.py states the bar): the ResNet
classifier's host-resized ("rsz") and device-resize ("full") steps, the
clip step of a temporal family both ways, a YOLOv8n served as its ONNX
graph (``models/onnx_graph_model.py``: the graph's folded constants become
the program's, the params its inputs) and a static-batch graph run through
``torch.func.vmap``. An 'rsz' program serves every source and is written
once per bucket. The pipeline serves a temporal artifact through the
batcher's clip path.
"""

import asyncio
import os
import sys
import zipfile

import numpy as np
import pytest

from realtime_analytics_tpu_torch.config import (
    ConfigError,
    DetectorConfig,
    KafkaSinkConfig,
    PipelineConfig,
    PrometheusConfig,
    SnapshotConfig,
    StreamConfig,
    TrackerConfig,
)
from realtime_analytics_tpu_torch.engine.detector import (
    TorchResNetEngine,
    TorchYoloEngine,
    create_detector,
)
from realtime_analytics_tpu_torch.engine.export import (
    ExportedResNetEngine,
    ExportedTemporalEngine,
    ExportedYoloEngine,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
from realtime_analytics_tpu_torch.models.weights import synthetic_params
from realtime_analytics_tpu_torch.models.yolo import build_yolo
from realtime_analytics_tpu_torch.types import FramePacket

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_export import _hold_no_weights  # noqa: E402

cv2 = pytest.importorskip("cv2")


def _packets(frames, name="cam"):
    stream = StreamConfig(name=name, url="synthetic://", target_fps=25)
    return [FramePacket(stream, f, i, float(i)) for i, f in enumerate(frames)]


def _dets_equal(a, b):
    assert len(a) == len(b)
    for da, db in zip(a, b):
        assert (da.class_id, da.confidence, da.bbox_xyxy) == (db.class_id, db.confidence,
                                                             db.bbox_xyxy)


def _resnet_cfg(path, **over):
    kw = dict(model_path=path, model_type="resnet", device="cpu", input_size=[32, 32],
              resnet_num_classes=10, resnet_scores="softmax", confidence_threshold=1e-6,
              batch_buckets=[2], max_batch_size=2, warmup=False, precision="fp32")
    kw.update(over)
    return DetectorConfig(**kw)


@pytest.mark.parametrize("host_resize", ["on", "off"])
def test_resnet_export_roundtrip(host_resize, tmp_path):
    live = TorchResNetEngine(_resnet_cfg("resnet18-seeded", host_resize=host_resize))
    path = str(tmp_path / "resnet.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(64, 96)])
    assert meta["engine"] == "resnet"
    assert [p["kind"] for p in meta["programs"]] == ["rsz" if host_resize == "on" else "full"]
    _hold_no_weights(path, meta)
    served = create_detector(_resnet_cfg(path, host_resize=host_resize))
    assert isinstance(served, ExportedResNetEngine)
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (64, 96, 3), np.uint8) for _ in range(2)]
    live.predict_packets(_packets(frames))
    served.predict_packets(_packets(frames))
    a, b = live.predict_packets(_packets(frames)), served.predict_packets(_packets(frames))
    for ra, rb in zip(a, b):
        assert len(ra) > 0  # top-k classifications emitted
        _dets_equal(ra, rb)


def test_rsz_programs_deduplicated(tmp_path):
    live = TorchResNetEngine(_resnet_cfg("resnet18-seeded", host_resize="on"))
    path = str(tmp_path / "dedup.rvae")
    # (64, 96) repeated and a second resized source: one 32x32 'rsz' program
    meta = export_serving_artifact(live, path, src_hws=[(64, 96), (64, 96), (128, 128)])
    rows = meta["programs"]
    assert all(r["kind"] == "rsz" for r in rows) and len(rows) == 2
    assert len({r["name"] for r in rows}) == 1  # aliased to one program
    with zipfile.ZipFile(path) as zf:
        assert len([n for n in zf.namelist() if n.startswith("programs/")]) == 1
    served = create_detector(_resnet_cfg(path))
    rng = np.random.default_rng(7)
    for hw in [(64, 96), (128, 128)]:
        frames = [rng.integers(0, 256, (*hw, 3), np.uint8) for _ in range(2)]
        live.predict_packets(_packets(frames))
        for ra, rb in zip(live.predict_packets(_packets(frames)),
                          served.predict_packets(_packets(frames))):
            _dets_equal(ra, rb)
    with pytest.raises(ValueError, match="largest exported bucket 2"):
        served.predict_packets(_packets([frames[0]] * 3))


def _temporal_cfg(path, **over):
    kw = dict(model_path=path, model_type="cnn_lstm", device="cpu", input_size=[32, 32],
              sequence_length=4, sequence_stride=1, num_action_classes=8,
              confidence_threshold=1e-6, batch_buckets=[1], max_batch_size=1,
              warmup=False, precision="fp32")
    kw.update(over)
    return DetectorConfig(**kw)


@pytest.mark.parametrize("host_resize", ["on", "off"])
def test_temporal_export_roundtrip(host_resize, tmp_path):
    live = TorchTemporalEngine(_temporal_cfg("cnnlstm-seeded.npz", host_resize=host_resize))
    path = str(tmp_path / "temporal.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(48, 64)])
    assert meta["engine"] == "temporal" and meta["sequence_length"] == 4
    assert [p["kind"] for p in meta["programs"]] == ["rsz" if host_resize == "on" else "full"]
    _hold_no_weights(path, meta)
    served = create_detector(_temporal_cfg(path, host_resize=host_resize, sequence_length=8))
    assert isinstance(served, ExportedTemporalEngine)
    assert served.config.sequence_length == 4  # the artifact's clip length wins
    rng = np.random.default_rng(5)
    clip = _packets([rng.integers(0, 256, (48, 64, 3), np.uint8) for _ in range(4)])
    live.predict_clips([clip])
    served.predict_clips([clip])
    a, b = live.predict_clips([clip]), served.predict_clips([clip])
    assert len(a) == len(b) == 1 and len(a[0]) > 0
    for da, db in zip(a[0], b[0]):
        assert (da.class_id, da.confidence, da.action_label) == (db.class_id, db.confidence,
                                                                 db.action_label)
    with pytest.raises(ValueError, match="largest exported bucket 1"):
        served.predict_clips([clip, clip])


def test_pipeline_serves_temporal_artifact(tmp_path):
    from realtime_analytics_tpu_torch.pipeline import AnalyticsPipeline

    det = _temporal_cfg("cnnlstm-seeded.npz", temporal_overlap=0.0)
    path = str(tmp_path / "t.rvae")
    export_serving_artifact(TorchTemporalEngine(det), path, src_hws=[(32, 32)])
    cfg = PipelineConfig(
        streams=[StreamConfig(name="cam-0", url="synthetic://?width=32&height=32&boxes=1"
                              "&frames=9", target_fps=30, warmup_seconds=0.0, max_retries=1,
                              reconnect_backoff=2.0)],
        detector=_temporal_cfg(path, temporal_overlap=0.0, warmup=True,
                               warmup_source_hw=[32, 32]),
        tracker=TrackerConfig(),
        kafka=KafkaSinkConfig(enabled=True, transport="memory"),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        stats_interval_seconds=3600,
        temporal_clip_window_ms=5,  # the batcher's clip-coalescing path
    )
    pipeline = AnalyticsPipeline(cfg)
    asyncio.run(pipeline.run_for(30.0))
    assert isinstance(pipeline.detectors["__default__"], ExportedTemporalEngine)
    st = pipeline.batchers["__default__"].stats
    assert st.frames == 9
    assert st.clips == 2  # 9 frames, clips of 4, step 4: complete at frames 4 and 8


@pytest.fixture(scope="module")
def yolo_graph(tmp_path_factory):
    from realtime_analytics_tpu_torch.models.onnx_export import yolo_to_onnx

    model = build_yolo("yolov8", "n", 80)
    path = str(tmp_path_factory.mktemp("g") / "yolov8n.onnx")
    yolo_to_onnx(model, synthetic_params(model, seed=0), path, (64, 64))
    return path


def _graph_cfg(path, **over):
    kw = dict(model_path=path, model_type="yolov8", device="cpu", input_size=[64, 64],
              batch_buckets=[2], max_batch_size=2, confidence_threshold=0.25,
              warmup=False, precision="fp32")
    kw.update(over)
    return DetectorConfig(**kw)


def test_graph_backed_export_roundtrip(yolo_graph, tmp_path):
    live = TorchYoloEngine(_graph_cfg(yolo_graph))
    assert live._graph_backed
    path = str(tmp_path / "graph.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(100, 160)])
    assert meta["graph_backed"] is True and meta["programs"][0]["kind"] == "full"
    served = create_detector(_graph_cfg(path))
    assert isinstance(served, ExportedYoloEngine) and served._graph_backed
    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 256, (100, 160, 3), np.uint8) for _ in range(2)]
    live.predict_packets(_packets(frames))
    served.predict_packets(_packets(frames))
    a, b = live.predict_packets(_packets(frames)), served.predict_packets(_packets(frames))
    assert sum(len(r) for r in a) > 0
    for ra, rb in zip(a, b):
        _dets_equal(ra, rb)
    # the live engine's own plans are untouched by the trace
    for ra, rb in zip(a, live.predict_packets(_packets(frames))):
        _dets_equal(ra, rb)


def test_static_batch_graph_exports_through_vmap(yolo_graph, tmp_path):
    from realtime_analytics_tpu_torch.models.onnx_lite import read_onnx_model, write_onnx_model

    g = read_onnx_model(yolo_graph)
    static = str(tmp_path / "static.onnx")
    for name in {n.inputs[1] for n in g.nodes if n.op_type == "Reshape"}:
        t = g.initializers[name].copy()  # bake the batch: the 0 (copy) dims become 1
        t[t == 0] = 1
        g.initializers[name] = t
    write_onnx_model(static, g)
    live = TorchYoloEngine(_graph_cfg(static))
    assert not live.model.dynamic_batch  # served through torch.func.vmap
    path = str(tmp_path / "static.rvae")
    export_serving_artifact(live, path, src_hws=[(100, 160)])
    served = create_detector(_graph_cfg(path))
    frames = np.random.default_rng(4).integers(0, 256, (2, 100, 160, 3), np.uint8)
    live.predict_arrays(frames)
    served.predict_arrays(frames)
    a, b = live.predict_arrays(frames), served.predict_arrays(frames)
    for f in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_graph_backed_resnet_records_the_flag(tmp_path):
    import torch

    from realtime_analytics_tpu_torch.models.onnx_lite import (
        OnnxGraph,
        OnnxNode,
        write_onnx_model,
    )

    rng = np.random.default_rng(1)
    g = OnnxGraph(
        nodes=[OnnxNode("GlobalAveragePool", ["x"], ["p"], "pool"),
               OnnxNode("Flatten", ["p"], ["f"], "flat", {"axis": 1}),
               OnnxNode("Gemm", ["f", "w", "b"], ["y"], "fc", {"transB": 1})],
        initializers={"w": rng.standard_normal((10, 3)).astype(np.float32),
                      "b": np.zeros(10, np.float32)},
        inputs=["x"], outputs=["y"])
    onnx_path = str(tmp_path / "cls.onnx")
    write_onnx_model(onnx_path, g)
    live = TorchResNetEngine(_resnet_cfg(onnx_path, host_resize="off"))
    assert live.model.graph_backed
    path = str(tmp_path / "cls.rvae")
    assert export_serving_artifact(live, path, src_hws=[(64, 96)])["graph_backed"] is True
    served = create_detector(_resnet_cfg(path))
    frames = [np.full((64, 96, 3), 40 * i, np.uint8) for i in range(2)]
    live.predict_packets(_packets(frames))
    for ra, rb in zip(live.predict_packets(_packets(frames)),
                      served.predict_packets(_packets(frames))):
        _dets_equal(ra, rb)
    assert served._params["model/p0"].dtype == torch.float32
    with pytest.raises(ConfigError, match="artifact serves a 'resnet' engine"):
        create_detector(_temporal_cfg(path))


@pytest.mark.parametrize("kind", ["end_to_end_nms", "temporal_graph"])
def test_more_graph_kinds_export(kind, tmp_path):
    """A graph that ends in its own NonMaxSuppression (the engine's top-k
    path) and a CNN-LSTM clip graph trace and serve bit for bit too."""
    import os
    import sys

    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from test_onnx_graph_exec import _export
    from test_onnx_graph_serving import HW, NC, ForeignTemporal, _embedded_nms_graph

    from realtime_analytics_tpu_torch.models.onnx_lite import write_onnx_model

    path = str(tmp_path / f"{kind}.onnx")
    if kind == "end_to_end_nms":
        write_onnx_model(path, _embedded_nms_graph(np.random.default_rng(77)))
        kw = dict(backend="onnx", confidence_threshold=0.3, iou_threshold=0.45,
                  input_size=list(HW), num_classes=NC)
        live = create_detector(_graph_cfg(path, **kw))
        assert live.model.end2end
        src = HW
        inputs = np.random.default_rng(3).integers(0, 256, (2, *HW, 3), np.uint8)
    else:
        torch.manual_seed(101)
        _export(ForeignTemporal().eval(), torch.rand(1, 4, 3, 32, 32), path,
                dynamic_axes={"x": {0: "n"}})
        kw = dict(model_type="cnn_lstm", backend="onnx", num_action_classes=5,
                  host_resize="off", batch_buckets=[2], max_batch_size=2)
        live = create_detector(_temporal_cfg(path, **kw))
        assert live.model.graph_backed
        src = (40, 48)
        inputs = np.random.default_rng(7).integers(0, 256, (2, 4, *src, 3), np.uint8)
    rvae = str(tmp_path / f"{kind}.rvae")
    export_serving_artifact(live, rvae, src_hws=[src])
    if kind == "end_to_end_nms":
        served = create_detector(_graph_cfg(rvae, **kw))
        run = [lambda e: e.predict_arrays(inputs)]
        fields = ("boxes_xyxy", "scores", "class_ids", "num_valid")
    else:
        served = create_detector(_temporal_cfg(rvae, **kw))
        run = [lambda e: e.step_for(2, src)[0].run_host(inputs)]
    for fn in run * 2:  # each engine's first run of the shapes, then the comparison
        a, b = fn(live), fn(served)
    if kind == "end_to_end_nms":
        a, b = [getattr(a, f) for f in fields], [getattr(b, f) for f in fields]
        assert int(a[3].sum()) > 0
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
