"""The port's ONNX protobuf reader and writer (models/onnx_lite.py, a copy of
the JAX package's) and the three weights-.onnx loaders.

* every dtype round-trips through the port's writer and reader, and the
  JAX package's reader reads the port's bytes (and the other way round);
* negative int64 constants packed as 10-byte varints read back signed;
* a model's full graph round-trips node for node;
* the YOLO (Ultralytics names, fp32 and fp16), ResNet (torchvision names)
  and temporal (the four families' torch names) loaders read a weights-
  .onnx into trees bit-equal to the JAX package's loaders on the same file.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from realtime_analytics_tpu.models import onnx_lite as jax_lite  # noqa: E402
from realtime_analytics_tpu.models import weights as jax_weights  # noqa: E402
from realtime_analytics_tpu_torch.models import onnx_lite, weights  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tensors():
    rng = np.random.default_rng(0)
    return {
        "a.float32": rng.normal(size=(3, 4, 5)).astype(np.float32),
        "b.float16": rng.normal(size=(7,)).astype(np.float16),
        "c.int64": rng.integers(-5, 5, (2, 2)).astype(np.int64),
        "d.int8": rng.integers(-127, 127, (4, 8)).astype(np.int8),
        "e.uint8": rng.integers(0, 256, (3,)).astype(np.uint8),
        "f.int32": rng.integers(-2**30, 2**30, (5,)).astype(np.int32),
        "g.float64": rng.normal(size=(2, 3)),
        "h.bool": rng.integers(0, 2, (4,)).astype(np.bool_),
        "i.scalarish": np.asarray([3.5], dtype=np.float32),
    }


@pytest.mark.parametrize("writer,reader", [("port", "port"), ("port", "jax"),
                                           ("jax", "port")])
def test_roundtrip_all_dtypes(writer, reader, tmp_path):
    tensors = _tensors()
    path = tmp_path / "weights.onnx"
    (onnx_lite if writer == "port" else jax_lite).write_onnx_initializers(str(path), tensors)
    back = (onnx_lite if reader == "port" else jax_lite).read_onnx_initializers(str(path))
    assert set(back) == set(tensors)
    for k in tensors:
        assert back[k].dtype == tensors[k].dtype, k
        np.testing.assert_array_equal(back[k], tensors[k])


def test_packed_int64_data_negative_values(tmp_path):
    values = [-1, -123456789012345, 0, 7, 2**62]
    packed = b"".join(onnx_lite._varint(v & ((1 << 64) - 1)) for v in values)
    t = (onnx_lite._varint(1 << 3) + onnx_lite._varint(len(values))  # dims: [5]
         + onnx_lite._varint(2 << 3) + onnx_lite._varint(7)  # data_type = int64
         + onnx_lite._len_delimited(8, b"shape_const")  # name
         + onnx_lite._len_delimited(7, packed))  # int64_data, packed
    model = (onnx_lite._varint(1 << 3) + onnx_lite._varint(8)
             + onnx_lite._len_delimited(7, onnx_lite._len_delimited(5, t)))
    path = tmp_path / "neg.onnx"
    path.write_bytes(model)
    np.testing.assert_array_equal(onnx_lite.read_onnx_initializers(str(path))["shape_const"],
                                  np.asarray(values, dtype=np.int64))


def test_model_graph_roundtrip_matches_jax_reader(tmp_path):
    g = onnx_lite.OnnxGraph(
        nodes=[onnx_lite.OnnxNode("Conv", ["x", "w"], ["c"], name="conv",
                                  attrs={"strides": [2, 2], "pads": [1, 1, 1, 1]}),
               onnx_lite.OnnxNode("Resize", ["c", "", "s"], ["y"],
                                  attrs={"mode": "nearest", "nearest_mode": "floor"})],
        initializers={"w": np.ones((4, 3, 3, 3), np.float32),
                      "s": np.array([1, 1, 2, 2], np.float32)},
        inputs=["x"], outputs=["y"])
    path = tmp_path / "g.onnx"
    onnx_lite.write_onnx_model(str(path), g)
    for reader in (onnx_lite.read_onnx_model, jax_lite.read_onnx_model):
        back = reader(str(path))
        assert [(n.op_type, n.inputs, n.outputs, n.attrs) for n in back.nodes] == \
            [(n.op_type, n.inputs, n.outputs, n.attrs) for n in g.nodes]
        assert back.inputs == ["x"] and back.outputs == ["y"]
        for k, v in g.initializers.items():
            np.testing.assert_array_equal(back.initializers[k], v)


def _assert_bit_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, want))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        b = np.asarray(b)
        assert np.asarray(a).dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("version,half", [("yolov8", False), ("yolov8", True),
                                          ("yolov5", False)])
def test_yolo_weights_onnx_bit_equal_to_jax(version, half, tmp_path):
    from torch_mirror import TorchYoloMirror

    from realtime_analytics_tpu.models.yolo import build_yolo as jax_build
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    torch.manual_seed(12)
    nc = 8 if version == "yolov8" else 80
    jm = jax_build(version, "n", nc)
    if version == "yolov8":
        sd = {k: v.numpy() for k, v in TorchYoloMirror(jm).ultralytics_state_dict().items()}
    else:  # the golden fixture's synthetic Ultralytics-named v5n weights
        spec = importlib.util.spec_from_file_location(
            "gen_golden_fixture", os.path.join(REPO, "scripts", "gen_golden_fixture.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sd = mod.synthetic_weights_v5()
    if half:
        sd = {k: v.astype(np.float16) for k, v in sd.items()}
    path = tmp_path / "w.onnx"
    onnx_lite.write_onnx_initializers(str(path), sd)
    got = weights.load_yolo_checkpoint(build_yolo(version, "n", nc), str(path))
    want = jax_weights.load_yolo_checkpoint(jm, str(path))
    assert got is not None and want is not None
    _assert_bit_equal(got, want)


def test_resnet_weights_onnx_bit_equal_to_jax(tmp_path):
    from realtime_analytics_tpu.models.resnet import build_resnet as jax_build
    from realtime_analytics_tpu_torch.models.resnet import build_resnet

    spec = importlib.util.spec_from_file_location(
        "resnet_fidelity_mirror", os.path.join(REPO, "tests", "test_resnet_fidelity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    torch.manual_seed(6)
    sd = {k: v.detach().numpy() for k, v in mod.TorchResNet18(num_classes=11).state_dict().items()}
    path = tmp_path / "resnet18.onnx"
    onnx_lite.write_onnx_initializers(str(path), sd)
    got = weights.load_resnet_checkpoint(build_resnet("resnet18", 11), str(path))
    want = jax_weights.load_resnet_checkpoint(jax_build("resnet18", 11), str(path))
    assert got is not None and want is not None
    _assert_bit_equal(got, want)


@pytest.mark.parametrize("family", ["cnn_lstm", "conv_gru", "3d_cnn", "slow_fast"])
def test_temporal_weights_onnx_bit_equal_to_jax(family, tmp_path):
    from test_temporal_checkpoints import MIRRORS, _state_dict

    from realtime_analytics_tpu.models.temporal import build_temporal as jax_build
    from realtime_analytics_tpu_torch.models.temporal import build_temporal

    torch.manual_seed(40)
    tm = MIRRORS[family]().eval()
    path = tmp_path / f"{family}.onnx"
    onnx_lite.write_onnx_initializers(str(path), dict(_state_dict(tm)))
    nc = tm.fc.out_features
    got = weights.load_temporal_checkpoint(build_temporal(family, nc), str(path))
    want = jax_weights.load_temporal_checkpoint(jax_build(family, nc), str(path))
    assert got is not None and want is not None
    _assert_bit_equal(got, want)


def test_full_graph_onnx_is_no_checkpoint(tmp_path):
    """A full graph whose initializers carry no documented names loads no
    tree, on both sides (the engines then serve the graph itself)."""
    from realtime_analytics_tpu_torch.models.onnx_export import yolo_to_onnx
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    model = build_yolo("yolov8", "n", 4)
    path = tmp_path / "graph.onnx"
    yolo_to_onnx(model, weights.synthetic_params(model), str(path), input_hw=(64, 64))
    assert weights.load_yolo_checkpoint(model, str(path)) is None
