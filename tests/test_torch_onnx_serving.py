"""Generic ONNX-graph serving through the port's engines, against the JAX
package's engines on the same .onnx file and the same frames.

A ``.onnx`` whose initializers match no documented checkpoint layout but
that holds a full graph is served as that graph (``create_detector`` with
``device: cpu``), by the YOLO, ResNet and temporal engines. Bounds, as
tests/test_onnx_graph_serving.py's:

* detectors (static- and dynamic-batch exports, raw-matrix and end-to-end
  NMS, fp32): equal counts and classes, scores within 1e-3, boxes within
  0.5 px, frame by frame;
* classifier and temporal graphs: top-5 equal, logits (probabilities for
  the temporal engine) within 1e-4;
* ``graph_precision: bf16``: the model outputs within the repo's bf16 bound
  of JAX's bf16 engine (conf 0.02, boxes 1 px), quantization scales fp32;
* the export round trip: the port's ``yolo_to_onnx`` of a seeded tree,
  served as a graph, detects what the port's native engine detects on the
  same tree (scores 1e-3, boxes 0.5 px).
"""

import logging
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig  # noqa: E402
from realtime_analytics_tpu.config import StreamConfig as JaxStream  # noqa: E402
from realtime_analytics_tpu.engine.detector import JaxResNetEngine, JaxYoloEngine  # noqa: E402
from realtime_analytics_tpu.engine.temporal import JaxTemporalEngine  # noqa: E402
from realtime_analytics_tpu.types import FramePacket as JaxPacket  # noqa: E402
from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig  # noqa: E402
from realtime_analytics_tpu_torch.engine.detector import (  # noqa: E402
    TorchYoloEngine,
    create_detector,
)
from realtime_analytics_tpu_torch.models.onnx_exec import UnsupportedOnnxOp  # noqa: E402
from realtime_analytics_tpu_torch.models.onnx_graph_model import OnnxGraphYolo  # noqa: E402
from realtime_analytics_tpu_torch.models.onnx_lite import (  # noqa: E402
    OnnxGraph,
    OnnxNode,
    write_onnx_initializers,
    write_onnx_model,
)
from realtime_analytics_tpu_torch.types import FramePacket  # noqa: E402

from test_onnx_graph_exec import _export  # noqa: E402
from test_onnx_graph_serving import (  # noqa: E402
    HW,
    NC,
    Foreign3DCNN,
    ForeignClassifier,
    ForeignDetector,
    ForeignMobileNetV3,
    ForeignTemporal,
    _embedded_nms_graph,
)

SERVE_LOG = "matches no known checkpoint layout — serving its ONNX graph directly"


def _det_kw(path, **over):
    kw = dict(model_path=str(path), model_type="yolov8", backend="onnx",
              confidence_threshold=0.3, iou_threshold=0.45, input_size=list(HW),
              max_batch_size=4, batch_buckets=[4], warmup=False, precision="fp32",
              num_classes=NC)
    kw.update(over)
    return kw


def _pair(path, **over):
    port = create_detector(DetectorConfig(device="cpu", **_det_kw(path, **over)))
    ref = JaxYoloEngine(JaxConfig(**_det_kw(path, **over)))
    return port, ref


def _hold_detections(got, want, score_tol=1e-3, box_tol=0.5):
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    assert got.num_valid.sum() > 0, "nothing detected: the comparison holds nothing"
    for i in range(len(got.num_valid)):
        n = int(got.num_valid[i])
        a = np.argsort(-got.scores[i][:n], kind="stable")
        b = np.argsort(-want.scores[i][:n], kind="stable")
        np.testing.assert_array_equal(got.class_ids[i][:n][a], want.class_ids[i][:n][b])
        np.testing.assert_allclose(got.scores[i][:n][a], want.scores[i][:n][b], atol=score_tol)
        np.testing.assert_allclose(got.boxes_xyxy[i][:n][a], want.boxes_xyxy[i][:n][b],
                                   atol=box_tol)


@pytest.fixture(scope="module")
def foreign_onnx(tmp_path_factory):
    d = tmp_path_factory.mktemp("foreign")
    out = {}
    for kind, bake in (("static", True), ("dynamic", False)):
        torch.manual_seed(100)
        out[kind] = str(d / f"{kind}.onnx")
        _export(ForeignDetector(bake_batch=bake).eval(), torch.rand(1, 3, *HW), out[kind],
                dynamic_axes=None if bake else {"x": {0: "n"}})
    return out


@pytest.mark.parametrize("kind", ["static", "dynamic"])
@pytest.mark.parametrize("src_hw", [HW, (96, 128)])
def test_foreign_detector_serves_like_jax(foreign_onnx, kind, src_hw, caplog):
    """Through ``create_detector``: the graph path (the log line), no host
    pick (full frames through the device letterbox), vmap for the static
    export; detections equal to ``JaxYoloEngine``'s."""
    with caplog.at_level(logging.INFO):
        port, ref = _pair(foreign_onnx[kind])
    assert any(SERVE_LOG in r.getMessage() for r in caplog.records)
    assert port.model.graph_backed and port.model.dynamic_batch == (kind == "dynamic")
    assert port.compute_dtype == torch.float32
    frames = np.random.default_rng(5).integers(0, 256, (3, *src_hw, 3), dtype=np.uint8)
    assert port.host_prepare(frames, src_hw) == (frames, False)
    _hold_detections(port.predict_arrays(frames), ref.predict_arrays(frames))
    # the pipeline's grouped path takes the same step
    stream = StreamConfig(name="s", url="mem://")
    dets = port.predict_packets([FramePacket(stream, f, i, 0.0) for i, f in enumerate(frames)])
    assert [len(d) for d in dets] == port.predict_arrays(frames).num_valid.tolist()


def test_tiled_graph_serving_like_jax(foreign_onnx):
    """Tiling on a graph-backed engine: tiles ride the device-letterbox step
    (no host select), merged as the JAX engine merges."""
    port, ref = _pair(foreign_onnx["dynamic"], tiling=True, tiling_overlap=0.25)
    frames = np.random.default_rng(7).integers(0, 256, (2, 96, 112, 3), dtype=np.uint8)
    _hold_detections(port._predict_tiled_group(list(frames), (96, 112)),
                     ref._predict_tiled_group(list(frames), (96, 112)))


def test_graph_serves_fp32_under_default_precision(foreign_onnx):
    port = create_detector(DetectorConfig(device="cpu", **_det_kw(
        foreign_onnx["dynamic"], precision="bf16")))
    assert port.compute_dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in port.model.params().values())


def test_end_to_end_nms_export_like_jax(tmp_path):
    path = str(tmp_path / "e2e.onnx")
    write_onnx_model(path, _embedded_nms_graph(np.random.default_rng(77)))
    port, ref = _pair(path)
    assert port.model.graph_backed and port.model.end2end
    frames = np.random.default_rng(77).integers(0, 256, (3, *HW, 3), dtype=np.uint8)
    _hold_detections(port.predict_arrays(frames), ref.predict_arrays(frames))


def _nms_glue(outputs, glue):
    nodes = [OnnxNode("Reshape", ["x", "tb"], ["boxes"]),
             OnnxNode("Reshape", ["x", "ts"], ["scores_r"]),
             OnnxNode("Sigmoid", ["scores_r"], ["scores"]),
             OnnxNode("NonMaxSuppression", ["boxes", "scores", "mo", "it"], ["sel1"]),
             OnnxNode("NonMaxSuppression", ["boxes", "scores", "mo", "it"], ["sel2"])]
    if glue:
        nodes.append(OnnxNode("Cast", ["sel1"], ["glue"], attrs={"to": 1}))
    return OnnxGraph(nodes=nodes, initializers={
        "tb": np.array([1, 48, 4], np.int64), "ts": np.array([1, 4, 48], np.int64),
        "mo": np.array([3], np.int64), "it": np.array([0.5], np.float32)},
        inputs=["x"], outputs=outputs)


@pytest.mark.parametrize("outputs,glue,match", [
    (["sel2", "glue"], True, "feeds further graph"),
    (["sel1", "sel2"], False, "terminal NonMaxSuppression"),
])
def test_nms_glue_and_several_terminal_nms_refused(outputs, glue, match, tmp_path, caplog):
    g = _nms_glue(outputs, glue)
    with pytest.raises(UnsupportedOnnxOp, match=match):
        OnnxGraphYolo(g, model_type="yolov8", input_hw=(8, 8))
    # through the engine: not servable, logged, the seeded native model
    path = str(tmp_path / "glue.onnx")
    write_onnx_model(path, g)
    with caplog.at_level(logging.WARNING):
        eng = create_detector(DetectorConfig(device="cpu", **_det_kw(path, input_size=[32, 32])))
    assert not getattr(eng.model, "graph_backed", False)
    assert any("not servable" in r.getMessage() for r in caplog.records)


def test_documented_layouts_take_the_native_model(tmp_path):
    """A weights-.onnx in a documented layout loads through the named
    loaders (a native model), not the graph fallback."""
    from test_temporal_checkpoints import TorchCNNLSTM, _state_dict
    from torch_mirror import TorchYoloMirror

    from realtime_analytics_tpu.models.yolo import build_yolo as jax_build

    torch.manual_seed(103)
    path = tmp_path / "named_temporal.onnx"
    write_onnx_initializers(str(path), dict(_state_dict(TorchCNNLSTM(nc=5).eval())))
    eng = create_detector(DetectorConfig(
        model_path=str(path), model_type="cnn_lstm", device="cpu", input_size=[32, 32],
        sequence_length=4, num_action_classes=5, warmup=False, precision="fp32"))
    assert not getattr(eng.model, "graph_backed", False)
    path = tmp_path / "named_yolo.onnx"
    write_onnx_initializers(str(path), {k: v.numpy() for k, v in TorchYoloMirror(
        jax_build("yolov8", "n", 8)).ultralytics_state_dict().items()})
    eng = create_detector(DetectorConfig(
        model_path=str(path), device="cpu", input_size=[64, 64], num_classes=8,
        warmup=False, precision="fp32"))
    assert not getattr(eng.model, "graph_backed", False)


@pytest.mark.parametrize("family", ["classifier", "mobilenetv3"])
def test_classifier_graph_like_jax(family, tmp_path):
    torch.manual_seed(102)
    m = (ForeignClassifier() if family == "classifier" else ForeignMobileNetV3()).eval()
    nc = 9 if family == "classifier" else 7
    path = tmp_path / f"{family}.onnx"
    _export(m, torch.rand(1, 3, 48, 48), str(path), dynamic_axes={"x": {0: "n"}})
    kw = dict(model_path=str(path), model_type="resnet", backend="onnx", input_size=[48, 48],
              resnet_num_classes=nc, resnet_top_k=5, warmup=False, precision="fp32",
              max_batch_size=2, batch_buckets=[2], confidence_threshold=1e-3)
    port = create_detector(DetectorConfig(device="cpu", **kw))
    ref = JaxResNetEngine(JaxConfig(**kw))
    assert port.model.graph_backed
    frames = np.random.default_rng(8).integers(0, 256, (2, 64, 80, 3), np.uint8)
    s, c = port.classify(frames)
    rs, rc = jax.device_get(ref._get_step(2, (64, 80))(ref.params, frames))  # raw logits
    np.testing.assert_array_equal(c, np.asarray(rc))
    np.testing.assert_allclose(s, np.asarray(rs), atol=1e-4)


@pytest.mark.parametrize("family", ["cnn_lstm", "3d_cnn"])
def test_temporal_graph_like_jax(family, tmp_path):
    torch.manual_seed(101)
    t_len = 4
    m = (ForeignTemporal() if family == "cnn_lstm" else Foreign3DCNN()).eval()
    shape = (1, t_len, 3, 32, 32) if family == "cnn_lstm" else (1, 3, t_len, 32, 32)
    path = tmp_path / f"{family}.onnx"
    _export(m, torch.rand(*shape), str(path), dynamic_axes={"x": {0: "n"}})
    kw = dict(model_path=str(path), model_type=family, backend="onnx", input_size=[32, 32],
              sequence_length=t_len, sequence_stride=1, num_action_classes=5, warmup=False,
              precision="fp32", max_batch_size=2, batch_buckets=[2],
              confidence_threshold=1e-9)
    port = create_detector(DetectorConfig(device="cpu", **kw))
    ref = JaxTemporalEngine(JaxConfig(**kw))
    assert port.model.graph_backed
    rng = np.random.default_rng(7)
    frames = rng.integers(0, 256, (2, t_len, 40, 48, 3), np.uint8)
    got = port.predict_clips([[FramePacket(StreamConfig(name=f"s{c}", url="mem://"),
                                           frames[c, t], t, time.time())
                               for t in range(t_len)] for c in range(2)])
    want = ref.predict_clips([[JaxPacket(JaxStream(name=f"s{c}", url="mem://"),
                                         frames[c, t], t, time.time())
                               for t in range(t_len)] for c in range(2)])
    for g_, w_ in zip(got, want):
        assert [d.class_id for d in g_] == [d.class_id for d in w_] and len(g_) == 5
        np.testing.assert_allclose([d.confidence for d in g_], [d.confidence for d in w_],
                                   atol=1e-4)


def test_graph_precision_bf16_like_jax(foreign_onnx):
    port, ref = _pair(foreign_onnx["dynamic"], graph_precision="bf16")
    assert port.compute_dtype == torch.bfloat16
    assert all(v.dtype == torch.bfloat16 for v in port.model.params().values())
    x = np.random.default_rng(11).random((3, *HW, 3)).astype(np.float32)
    with torch.inference_mode():
        a = port.model(torch.from_numpy(x).to(torch.bfloat16), reduce_scores=True)
    b = jax.jit(lambda p, v: ref.model.apply(p, v, reduce_scores=True))(
        ref.params, jax.numpy.asarray(x, jax.numpy.bfloat16))
    np.testing.assert_allclose(a["conf"].numpy(), np.asarray(b["conf"]), atol=0.02)
    np.testing.assert_allclose(a["boxes_xyxy"].numpy(), np.asarray(b["boxes_xyxy"]), atol=1.0)


def test_bf16_keeps_quant_scales_fp32_and_int8_warns(tmp_path, caplog):
    """A QDQ detector under ``graph_precision: bf16`` and ``precision:
    int8``: int8 is refused with a warning (served at graph_precision);
    int8 weights stay int8 and quantization scales fp32; the rest bf16."""
    from test_onnx_quant import _QdqForeignDetector

    path = tmp_path / "qdq.onnx"
    _export(_QdqForeignDetector(HW, NC).eval(), torch.rand(1, 3, *HW), str(path),
            dynamic_axes={"x": {0: "n"}})
    with caplog.at_level(logging.WARNING):
        port = create_detector(DetectorConfig(device="cpu", **_det_kw(
            path, precision="int8", graph_precision="bf16")))
    assert any("int8 is not supported for generic ONNX graph" in r.getMessage()
               for r in caplog.records)
    params = port.model.params()
    scales = port.model.fp32_param_names
    assert scales and all(params[k].dtype == torch.float32 for k in scales)
    assert sum(v.dtype == torch.int8 for v in params.values()) >= 4
    assert all(v.dtype == torch.bfloat16 for k, v in params.items()
               if k not in scales and v.is_floating_point())
    frames = np.random.default_rng(3).integers(0, 256, (2, *HW, 3), dtype=np.uint8)
    res = port.predict_arrays(frames)
    assert np.isfinite(res.scores).all()


def test_graph_mesh_is_dp_only(foreign_onnx):
    """A foreign graph takes a dp-only mesh, as in the JAX engine: tp > 1
    raises its ConfigError; ``mesh_shape: [2, 1]`` splits the batch with
    replicated weights and serves the detections of one device."""
    from realtime_analytics_tpu_torch.config import ConfigError

    with pytest.raises(ConfigError, match="dp-only meshes"):
        create_detector(DetectorConfig(device="cpu", mesh_shape=[2, 2],
                                       **_det_kw(foreign_onnx["dynamic"])))
    sharded = create_detector(DetectorConfig(device="cpu", mesh_shape=[2, 1],
                                             **_det_kw(foreign_onnx["dynamic"])))
    one = create_detector(DetectorConfig(device="cpu", **_det_kw(foreign_onnx["dynamic"])))
    assert sharded.mesh.shape == {"dp": 2, "tp": 1} and sharded.sharded.net is sharded.model
    frames = np.random.default_rng(8).integers(0, 256, (3, *HW, 3), dtype=np.uint8)
    _hold_detections(sharded.predict_arrays(frames), one.predict_arrays(frames))


def test_export_round_trip_graph_equals_native(tmp_path):
    """The port's ``yolo_to_onnx`` of a seeded tree, served as a graph,
    detects what the native engine detects with the same tree."""
    from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource
    from realtime_analytics_tpu_torch.models.onnx_export import yolo_to_onnx
    from realtime_analytics_tpu_torch.models.weights import synthetic_params
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    model = build_yolo("yolov8", "n", 8)
    tree = synthetic_params(model, seed=5)
    path = str(tmp_path / "v8.onnx")
    yolo_to_onnx(model, tree, path, (128, 128))
    common = dict(input_size=[128, 128], confidence_threshold=0.05, max_batch_size=2,
                  batch_buckets=[2], warmup=False, precision="fp32", device="cpu",
                  num_classes=8)
    native = TorchYoloEngine(DetectorConfig(model_path="absent-yolov8n.pt", **common),
                             params=tree)
    graph = create_detector(DetectorConfig(model_path=path, **common))
    assert graph.model.graph_backed and not getattr(native.model, "graph_backed", False)
    frames = np.stack([SyntheticSource(width=160, height=128, boxes=3, seed=5 + i).read()[1]
                       for i in range(2)])
    _hold_detections(graph.predict_arrays(frames), native.predict_arrays(frames))


def test_run_pipeline_cli_serves_an_onnx_file(foreign_onnx, tmp_path):
    """``python -m realtime_analytics_tpu_torch.scripts.run_pipeline`` with
    ``detector.model_path`` set to a foreign ``.onnx``: the repo's sim
    config, cut to the CPU, serves the graph."""
    import yaml

    from realtime_analytics_tpu_torch.scripts import run_pipeline

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, "config", "pipeline-sim.yaml")) as f:
        raw = yaml.safe_load(f)
    raw["detector"].update(device="cpu", input_size=list(HW), precision="fp32",
                           num_classes=NC, model_path=foreign_onnx["dynamic"])
    path = tmp_path / "sim.yaml"
    path.write_text(yaml.safe_dump(raw))
    log = tmp_path / "pipeline.log"
    assert run_pipeline.main(["--config", str(path), "--duration", "1.5", "--log-level",
                              "INFO", "--log-file", str(log)]) == 0
    assert SERVE_LOG in log.read_text()
