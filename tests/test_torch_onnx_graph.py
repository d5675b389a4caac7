"""Whole ONNX graphs through the port's interpreter (models/onnx_torch.py)
against the JAX package's (models/onnx_jax.py), on the same seeded inputs.

* YOLOv8n at 160, exported by the JAX package's ``yolo_to_onnx`` and by
  tests/torch_mirror.py's ``TorchYoloMirror`` (torch's own exporter): the
  port against JAX (run under ``jax.jit``, as the JAX test does) and the
  numpy oracle at atol 5e-3, rtol 1e-3 (tests/test_onnx_jax.py:223: pixel
  boxes up to 160 summed through ~60 convs in another order);
* the four temporal families (LSTM and the unrolled ConvGRU among them),
  bidirectional LSTM and GRU layers, MobileNetV3 and ViT blocks, a torch
  fake-quant QDQ export (folded as the adapters fold it): 1e-4 and 1e-5;
* the plan: a planned call equals the unplanned interpreter bit for bit,
  plans once per input shape, and runs fewer ops than the graph has nodes
  when Shape chains fold;
* a static-batch export served through ``torch.func.vmap`` equals the
  dynamic-batch export served directly;
* the port's ``yolo_to_onnx`` writes the same bytes as the JAX package's.
"""

import os
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from realtime_analytics_tpu.models import onnx_jax  # noqa: E402
from realtime_analytics_tpu.models.onnx_exec import run_graph  # noqa: E402
from realtime_analytics_tpu.models.onnx_lite import read_onnx_model  # noqa: E402
from realtime_analytics_tpu_torch.models import onnx_torch  # noqa: E402
from realtime_analytics_tpu_torch.models.onnx_graph_model import (  # noqa: E402
    OnnxGraphClassifier,
    OnnxGraphYolo,
    fold_constants,
)
from realtime_analytics_tpu_torch.models.onnx_lite import (  # noqa: E402
    read_onnx_model as port_read,
)

from test_onnx_graph_exec import _export  # noqa: E402


def _both(path, feeds, atol, rtol, oracle=True):
    """The port's outputs against JAX's jitted ones (and the oracle's)."""
    g = read_onnx_model(str(path))
    pg = port_read(str(path))
    names = list(feeds)
    fn = onnx_jax.compile_graph(g)
    ref = jax.jit(lambda *a: fn(dict(zip(names, a))))(*[jnp.asarray(feeds[n]) for n in names])
    got = onnx_torch.compile_graph(pg)({k: torch.from_numpy(v) for k, v in feeds.items()})
    want = run_graph(g, feeds) if oracle else ref
    assert len(got) == len(ref) == len(want)
    for p, j, w in zip(got, ref, want):
        p = p.numpy()
        np.testing.assert_allclose(p, np.asarray(j), atol=atol, rtol=rtol)
        np.testing.assert_allclose(p, np.asarray(w), atol=atol, rtol=rtol)
    return got


@pytest.fixture(scope="module")
def v8_tree():
    from realtime_analytics_tpu.models.yolo import build_yolo

    model = build_yolo("yolov8", "n", 80)
    return model, jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(3)))


def test_yolov8n_native_export_against_jax(v8_tree, tmp_path):
    from realtime_analytics_tpu.models.onnx_export import yolo_to_onnx

    model, tree = v8_tree
    path = tmp_path / "v8.onnx"
    yolo_to_onnx(model, tree, str(path), input_hw=(160, 160))
    x = np.random.default_rng(11).random((2, 3, 160, 160)).astype(np.float32)
    (out,) = _both(path, {"images": x}, atol=5e-3, rtol=1e-3)
    assert tuple(out.shape) == (2, 84, 525)


def test_yolov8n_torch_mirror_export_against_jax(tmp_path):
    from torch_mirror import TorchYoloMirror

    from realtime_analytics_tpu.models.yolo import build_yolo

    torch.manual_seed(7)
    tm = TorchYoloMirror(build_yolo("yolov8", "n", nc=80)).eval()
    path = tmp_path / "v8m.onnx"
    _export(tm, torch.rand(1, 3, 160, 160), str(path))
    x = np.random.default_rng(12).random((1, 3, 160, 160)).astype(np.float32)
    _both(path, {"x": x}, atol=5e-3, rtol=1e-3)


@pytest.mark.parametrize("family", ["cnn_lstm", "conv_gru", "3d_cnn", "slow_fast"])
def test_temporal_family_graphs(family, tmp_path):
    from test_temporal_checkpoints import CLIP, MIRRORS

    torch.manual_seed(30 + sorted(MIRRORS).index(family))
    tm = MIRRORS[family]().eval()
    clips = torch.rand(*CLIP)
    path = tmp_path / f"{family}.onnx"
    _export(tm, clips, str(path))
    _both(path, {"x": clips.numpy()}, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("kind,bidirectional", [("lstm", False), ("lstm", True),
                                                ("gru", False), ("gru", True)])
def test_recurrent_layers(kind, bidirectional, tmp_path):
    torch.manual_seed(5)

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            cls = nn.LSTM if kind == "lstm" else nn.GRU
            self.rnn = cls(10, 7, batch_first=True, bidirectional=bidirectional)

        def forward(self, x):
            out = self.rnn(x)
            hs, state = out
            return (hs, *state) if kind == "lstm" else (hs, state)

    path = tmp_path / f"{kind}.onnx"
    x = torch.rand(3, 6, 10)
    _export(M().eval(), x, str(path))
    _both(path, {"x": x.numpy()}, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("family", ["mobilenetv3", "vit"])
def test_modern_classifier_blocks(family, tmp_path):
    from test_onnx_graph_serving import ForeignMobileNetV3, ForeignViT

    torch.manual_seed(110)
    m = (ForeignMobileNetV3() if family == "mobilenetv3" else ForeignViT()).eval()
    path = tmp_path / f"{family}.onnx"
    x = torch.rand(2, 3, 48, 48)
    _export(m, x, str(path), dynamic_axes={"x": {0: "n"}})
    (got,) = _both(path, {"x": x.numpy()}, atol=1e-5, rtol=1e-4)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), m(x).numpy(), atol=1e-4, rtol=1e-4)


def test_fused_qdq_export(tmp_path):
    """torch's fake-quant QDQ export, constant-folded as the adapters fold
    it (weights int8 behind a live DequantizeLinear): the port equals the
    JAX interpreter on the same folded graph, and torch's own forward."""
    from test_onnx_quant import _FakeQuantModel

    from realtime_analytics_tpu.models.onnx_graph_model import fold_constants as jax_fold

    m = _FakeQuantModel().eval()
    x = torch.rand(2, 3, 16, 16)
    path = tmp_path / "qdq.onnx"
    _export(m, x, str(path))
    pg, jg = fold_constants(port_read(str(path))), jax_fold(read_onnx_model(str(path)))
    assert any(v.dtype == np.int8 for v in pg.initializers.values()), "no int8 weight folded"
    assert [n.op_type for n in pg.nodes] == [n.op_type for n in jg.nodes]
    name = jg.inputs[0]
    fn = onnx_jax.compile_graph(jg)
    (ref,) = jax.jit(lambda a: fn({name: a}))(jnp.asarray(x.numpy()))
    (got,) = onnx_torch.compile_graph(pg)({name: x})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(got.numpy(), m(x).numpy(), atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# the plan


class _ShapeChainNet(nn.Module):
    """A dynamic-batch export whose reshapes are Shape -> Gather -> Concat
    chains (the numpy folds a plan saves)."""

    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, stride=2, padding=1)
        self.up = nn.Upsample(scale_factor=2, mode="nearest")

    def forward(self, x):
        y = torch.relu(self.conv(x))
        n, c, h, w = y.shape
        y = y.reshape(n, c // 2, 2, h * w).softmax(2).reshape(n, c, h, w)
        return self.up(y).flatten(1)


def test_planned_equals_unplanned(tmp_path):
    path = tmp_path / "chain.onnx"
    _export(_ShapeChainNet().eval(), torch.rand(2, 3, 16, 16), str(path),
            dynamic_axes={"x": {0: "n"}})
    g = port_read(str(path))
    assert any(n.op_type == "Shape" for n in g.nodes)
    fn = onnx_torch.compile_graph(g)
    for b in (1, 3):
        x = torch.from_numpy(np.random.default_rng(b).random((b, 3, 16, 16)).astype(np.float32))
        first = fn({"x": x})  # plans
        plan = fn.plan_for({"x": x})
        assert plan is not None and 0 < len(plan.steps) < len(g.nodes)
        again = fn({"x": x})  # runs the plan
        assert fn.plan_for({"x": x}) is plan
        unplanned = fn.unplanned({"x": x})
        for a, b_, c in zip(first, again, unplanned):
            assert torch.equal(a, b_) and torch.equal(b_, c)
    assert len(fn._plans) == 2  # one plan per input shape
    # the bf16 policy is part of the key
    with onnx_torch.graph_compute_dtype(torch.bfloat16):
        (y16,) = fn({"x": x})
    assert y16.dtype == torch.bfloat16 and len(fn._plans) == 3


def test_static_batch_vmap_equals_dynamic(tmp_path):
    """A batch-1-baked export serves through ``torch.func.vmap`` over the
    batch-1 plan and equals the dynamic export served directly."""
    from test_onnx_graph_serving import HW, ForeignDetector

    paths = {}
    for bake in (True, False):
        torch.manual_seed(100)
        m = ForeignDetector(bake_batch=bake).eval()
        paths[bake] = tmp_path / f"det_{bake}.onnx"
        _export(m, torch.rand(1, 3, *HW), str(paths[bake]),
                dynamic_axes=None if bake else {"x": {0: "n"}})
    static = OnnxGraphYolo(port_read(str(paths[True])), "yolov8", HW)
    dynamic = OnnxGraphYolo(port_read(str(paths[False])), "yolov8", HW)
    assert not static.dynamic_batch and dynamic.dynamic_batch
    x = torch.from_numpy(np.random.default_rng(4).random((3, *HW, 3)).astype(np.float32))
    a, b = static(x, reduce_scores=True), dynamic(x, reduce_scores=True)
    for k in ("boxes_xyxy", "conf"):
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-5, rtol=1e-5)
    assert torch.equal(a["cls"], b["cls"])


def test_meta_probe_runs_no_operation(tmp_path):
    """The adapters probe on the meta device: the classifier probe of a
    graph whose Reshape target depends on the batch fails there as a
    static export (vmap), with no value read."""
    from test_onnx_graph_serving import ForeignClassifier

    torch.manual_seed(102)
    path = tmp_path / "cls.onnx"
    _export(ForeignClassifier().eval(), torch.rand(1, 3, 48, 48), str(path))
    gm = OnnxGraphClassifier(port_read(str(path)), (48, 48))
    assert all(v.device.type == "meta" for v in gm.meta_params().values())
    x = torch.rand(2, 48, 48, 3)
    assert tuple(gm(x).shape) == (2, 9)


# ---------------------------------------------------------------------------
# the exporter


@pytest.mark.parametrize("version,int8", [("yolov8", False), ("yolov5", False),
                                          ("yolov8", True)])
def test_yolo_to_onnx_bytes_equal_jax(version, int8, tmp_path):
    from realtime_analytics_tpu.models.onnx_export import yolo_to_onnx as jax_export
    from realtime_analytics_tpu.models.yolo import build_yolo as jax_build
    from realtime_analytics_tpu_torch.models.onnx_export import yolo_to_onnx
    from realtime_analytics_tpu_torch.models.weights import (
        quantize_params_int8,
        synthetic_params,
    )
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    model = build_yolo(version, "n", 7)
    tree = synthetic_params(model, seed=2)
    if int8:
        tree = quantize_params_int8(tree)
    a, b = tmp_path / "port.onnx", tmp_path / "jax.onnx"
    yolo_to_onnx(model, tree, str(a), input_hw=(96, 128))
    jax_export(jax_build(version, "n", 7), tree, str(b), input_hw=(96, 128))
    assert a.read_bytes() == b.read_bytes()
