"""The port's quantiser (``models/quantize.py``, a numpy copy) and its CLI.

Counterpart of tests/test_quantize_tool.py. The port's ``quantize_graph``
reads the port's own ``onnx_exec`` and ``onnx_lite``; on the same graph and
the same calibration feeds it writes the same bytes as the JAX package's
(QDQ, QOperator, weights-only, with an excluded node), and its CLI writes
the same files as the JAX package's CLI. A quantised detector graph serves
through the port's engine like the JAX engine serves it, and exports to a
``.rvae`` that serves it bit for bit.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig  # noqa: E402
from realtime_analytics_tpu.engine.detector import JaxYoloEngine  # noqa: E402
from realtime_analytics_tpu.models.onnx_lite import (  # noqa: E402
    read_onnx_model as jax_read_onnx_model,
)
from realtime_analytics_tpu.models.onnx_lite import (  # noqa: E402
    write_onnx_model as jax_write_onnx_model,
)
from realtime_analytics_tpu.models.quantize import (  # noqa: E402
    quantize_graph as jax_quantize_graph,
)
from realtime_analytics_tpu.scripts.quantize_model import main as jax_quantize_main  # noqa: E402
from realtime_analytics_tpu_torch.config import DetectorConfig  # noqa: E402
from realtime_analytics_tpu_torch.engine.detector import create_detector  # noqa: E402
from realtime_analytics_tpu_torch.engine.export import (  # noqa: E402
    ExportedYoloEngine,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.models.onnx_exec import run_graph  # noqa: E402
from realtime_analytics_tpu_torch.models.onnx_lite import (  # noqa: E402
    read_onnx_model,
    write_onnx_model,
)
from realtime_analytics_tpu_torch.models.quantize import quantize_graph  # noqa: E402
from realtime_analytics_tpu_torch.scripts.quantize_model import main  # noqa: E402

from test_onnx_graph_exec import _export  # noqa: E402
from test_onnx_graph_serving import HW, NC, ForeignDetector  # noqa: E402
from test_quantize_tool import _SmallNet, _feeds  # noqa: E402


@pytest.fixture(scope="module")
def small_onnx(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("small") / "small.onnx")
    _export(_SmallNet().eval(), torch.rand(1, 3, 16, 16), path, dynamic_axes={"x": {0: "n"}})
    return path


@pytest.fixture(scope="module")
def detector_onnx(tmp_path_factory):
    torch.manual_seed(100)
    path = str(tmp_path_factory.mktemp("det") / "det.onnx")
    _export(ForeignDetector().eval(), torch.rand(1, 3, *HW), path, dynamic_axes={"x": {0: "n"}})
    return path


def _bytes(writer, path, graph):
    writer(path, graph)
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("fmt,over", [
    ("qdq", {}),
    ("qoperator", {}),
    ("qdq", {"weights_only": True}),
    ("qoperator", {"exclude": ["/c2/Conv"]}),
])
def test_quantize_graph_bytes_equal_jax(small_onnx, fmt, over, tmp_path):
    g, jg = read_onnx_model(small_onnx), jax_read_onnx_model(small_onnx)
    feeds = [] if over.get("weights_only") else _feeds(g)
    qg, rep = quantize_graph(g, feeds, fmt=fmt, **over)
    jqg, jrep = jax_quantize_graph(jg, feeds, fmt=fmt, **over)
    assert rep.summary() == jrep.summary()
    got = _bytes(write_onnx_model, str(tmp_path / "port.onnx"), qg)
    want = _bytes(jax_write_onnx_model, str(tmp_path / "jax.onnx"), jqg)
    assert got == want
    assert len(rep.weights_quantized) > 0


def test_quantize_detector_graph_bytes_equal_jax(detector_onnx, tmp_path):
    g, jg = read_onnx_model(detector_onnx), jax_read_onnx_model(detector_onnx)
    rng = np.random.default_rng(23)
    feeds = [{g.inputs[0]: rng.random((1, 3, *HW), dtype=np.float32)} for _ in range(3)]
    for fmt in ("qdq", "qoperator"):
        got = _bytes(write_onnx_model, str(tmp_path / f"p-{fmt}.onnx"),
                     quantize_graph(g, feeds, fmt=fmt)[0])
        want = _bytes(jax_write_onnx_model, str(tmp_path / f"j-{fmt}.onnx"),
                      jax_quantize_graph(jg, feeds, fmt=fmt)[0])
        assert got == want, fmt


@pytest.mark.parametrize("args", [
    ["--calib", "synthetic", "--input-shape", "3,16,16", "--samples", "4",
     "--format", "qoperator", "--check"],
    ["--calib", "CALIB", "--samples", "3", "--format", "qdq"],
    ["--weights-only", "--input-shape", "3,16,16"],
])
def test_cli_writes_what_the_jax_cli_writes(small_onnx, args, tmp_path):
    calib = str(tmp_path / "calib.npz")
    np.savez(calib, x=np.random.default_rng(0).random((5, 3, 16, 16), dtype=np.float32))
    args = [calib if a == "CALIB" else a for a in args]
    out, jout = str(tmp_path / "port.onnx"), str(tmp_path / "jax.onnx")
    assert main(["--model", small_onnx, "--out", out, *args]) == 0
    assert jax_quantize_main(["--model", small_onnx, "--out", jout, *args]) == 0
    with open(out, "rb") as a, open(jout, "rb") as b:
        assert a.read() == b.read()
    qg = read_onnx_model(out)
    x = np.random.default_rng(2).random((2, 3, 16, 16), dtype=np.float32)
    g = read_onnx_model(small_onnx)
    (want,) = run_graph(g, {g.inputs[0]: x})
    (got,) = run_graph(qg, {qg.inputs[0]: x})
    assert np.abs(got - want).max() / (np.abs(want).max() + 1e-9) < 0.08


def test_cli_refuses_missing_inputs(small_onnx, tmp_path):
    with pytest.raises(SystemExit, match="input-shape"):
        main(["--model", small_onnx, "--out", str(tmp_path / "q.onnx"), "--calib", "synthetic"])
    with pytest.raises(SystemExit, match="not found"):
        main(["--model", small_onnx, "--out", str(tmp_path / "q.onnx"),
              "--calib", str(tmp_path / "absent.npz")])


def _det_kw(path, **over):
    kw = dict(model_path=path, model_type="yolov8", confidence_threshold=0.3,
              iou_threshold=0.45, input_size=list(HW), max_batch_size=2, batch_buckets=[2],
              warmup=False, precision="fp32", num_classes=NC)
    kw.update(over)
    return kw


@pytest.mark.parametrize("fmt", ["qdq", "qoperator"])
def test_quantized_graph_serves_like_jax_and_exports(detector_onnx, fmt, tmp_path):
    g = read_onnx_model(detector_onnx)
    rng = np.random.default_rng(31)
    feeds = [{g.inputs[0]: rng.random((1, 3, *HW), dtype=np.float32)} for _ in range(3)]
    qpath = str(tmp_path / f"det-{fmt}.onnx")
    write_onnx_model(qpath, quantize_graph(g, feeds, fmt=fmt)[0])
    live = create_detector(DetectorConfig(device="cpu", **_det_kw(qpath)))
    assert live._graph_backed
    assert any(v.dtype == torch.int8 for v in live.model.params().values())
    ref = JaxYoloEngine(JaxConfig(**_det_kw(qpath)))
    frames = rng.integers(0, 256, (2, *HW, 3), dtype=np.uint8)
    got, want = live.predict_arrays(frames), ref.predict_arrays(frames)
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    assert got.num_valid.sum() > 0
    for i, n in enumerate(got.num_valid):
        a = np.argsort(-got.scores[i][:n], kind="stable")
        b = np.argsort(-want.scores[i][:n], kind="stable")
        np.testing.assert_array_equal(got.class_ids[i][:n][a], want.class_ids[i][:n][b])
        np.testing.assert_allclose(got.scores[i][:n][a], want.scores[i][:n][b], atol=1e-3)
        np.testing.assert_allclose(got.boxes_xyxy[i][:n][a], want.boxes_xyxy[i][:n][b],
                                   atol=0.5)
    rvae = str(tmp_path / f"det-{fmt}.rvae")
    meta = export_serving_artifact(live, rvae, src_hws=[HW])
    assert any(spec["dtype"] == "int8" for spec in meta["params"].values())
    served = create_detector(DetectorConfig(device="cpu", **_det_kw(rvae)))
    assert isinstance(served, ExportedYoloEngine)
    served.predict_arrays(frames)
    a, b = live.predict_arrays(frames), served.predict_arrays(frames)
    for f in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
