"""The port's ResNet classifier against the JAX package, on the CPU.

1. ``ResNetModel.forward`` against JAX ``ResNetModel.apply`` on the same
   params tree (JAX ``init_params``, carried across as numpy through
   ``resnet_params_from_jax``), fp32, narrow inputs: atol 2e-3 / rtol 1e-3,
   the tolerance of the JAX package's own fidelity test
   (tests/test_resnet_fidelity.py). Both sum convolutions in fp32 in
   another order.
2. The torchvision-layout loader against JAX
   ``resnet_params_from_state_dict``, on a state dict of the torch mirror of
   tests/test_resnet_fidelity.py: equal trees (atol 1e-6, both fold BN in
   fp32 numpy) and logits equal to the mirror's within the same tolerance.
3. ``TorchResNetEngine(device: cpu)`` against ``JaxResNetEngine`` end to
   end through ``predict_packets``, with ``host_resize`` on (both stretch
   with cv2) and off (the device step: ``F.interpolate`` against
   ``jax.image.resize``, both unrounded): equal top-k classes, raw scores
   atol 2e-3 and softmax scores atol 1e-5.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.config import StreamConfig as JaxStream
from realtime_analytics_tpu.engine.detector import JaxResNetEngine
from realtime_analytics_tpu.models.resnet import build_resnet as jax_build_resnet
from realtime_analytics_tpu.models.weights import (
    resnet_params_from_state_dict as jax_resnet_params_from_state_dict,
)
from realtime_analytics_tpu.types import FramePacket as JaxPacket
from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
from realtime_analytics_tpu_torch.engine.detector import TorchResNetEngine, create_detector
from realtime_analytics_tpu_torch.models.resnet import build_resnet, variant_from_model_path
from realtime_analytics_tpu_torch.models.weights import (
    load_resnet_checkpoint,
    module_tree,
    resnet_params_from_jax,
    resnet_params_from_state_dict,
    resnet_synthetic_params,
)
from realtime_analytics_tpu_torch.types import FramePacket

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _mirror():
    spec = importlib.util.spec_from_file_location(
        "resnet_fidelity_mirror", os.path.join(REPO, "tests", "test_resnet_fidelity.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.TorchResNet18


def _assert_trees_close(a, b, atol):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=0)


@pytest.mark.parametrize("variant,hw", [("resnet18", 64), ("resnet34", 32), ("resnet50", 32)])
def test_forward_matches_jax_apply(variant, hw):
    jm = jax_build_resnet(variant, num_classes=10)
    params = _np_tree(jm.init_params(jax.random.PRNGKey(3)))
    x = np.random.default_rng(0).normal(0, 1, (2, hw, hw, 3)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(x)))
    model = resnet_params_from_jax(build_resnet(variant, 10), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)
    _assert_trees_close(module_tree(model), params, atol=0)


def test_torchvision_loader_matches_jax_loader():
    torch.manual_seed(6)
    mirror = _mirror()(num_classes=37).eval()
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    want_tree = jax_resnet_params_from_state_dict(jax_build_resnet("resnet18", 37), sd)
    model = build_resnet("resnet18", 37)
    tree = resnet_params_from_state_dict(model, sd)
    _assert_trees_close(tree, want_tree, atol=1e-6)
    resnet_params_from_jax(model, tree).eval()
    x = torch.rand(2, 3, 96, 96)
    with torch.no_grad():
        want = mirror(x).numpy()
        got = model(x.permute(0, 2, 3, 1)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("carrier", ["pt", "npz", "pytree"])
def test_checkpoint_carriers(tmp_path, carrier):
    torch.manual_seed(1)
    mirror = _mirror()(num_classes=10).eval()
    sd = {k: v.detach().numpy() for k, v in mirror.state_dict().items()}
    model = build_resnet("resnet18", 10)
    want = resnet_params_from_state_dict(model, sd)
    path = tmp_path / f"resnet18.{'pt' if carrier == 'pt' else 'npz'}"
    if carrier == "pt":
        torch.save(mirror.state_dict(), path)
    elif carrier == "npz":
        np.savez(path, **sd)
    else:
        np.savez(path, __pytree__=np.array(want, dtype=object))
    _assert_trees_close(load_resnet_checkpoint(model, str(path)), want, atol=1e-6)


def test_loader_refuses_onnx_and_survives_a_bad_file(tmp_path):
    model = build_resnet("resnet18", 10)
    # an unreadable weights-.onnx is no checkpoint (real ones:
    # tests/test_torch_onnx_lite.py)
    assert load_resnet_checkpoint(model, str(tmp_path / "w.onnx")) is None
    bad = tmp_path / "other.npz"
    np.savez(bad, __pytree__=np.array({"stem": {}}, dtype=object))
    assert load_resnet_checkpoint(model, str(bad)) is None
    assert load_resnet_checkpoint(model, str(tmp_path / "absent.pt")) is None


def test_synthetic_params_are_seeded_and_fit():
    model = build_resnet("resnet50", 1000)
    a, b = resnet_synthetic_params(model, seed=4), resnet_synthetic_params(model, seed=4)
    _assert_trees_close(a, b, atol=0)
    resnet_params_from_jax(model, a)  # every shape matches
    assert variant_from_model_path("models/resnet34_imagenet.pt") == "resnet34"
    assert variant_from_model_path("classifier.pt") == "resnet50"


def _frames():
    rng = np.random.default_rng(5)
    small = rng.integers(0, 256, (3, 16, 21, 3), np.uint8)
    return [cv2.resize(f, (160, 120), interpolation=cv2.INTER_LINEAR) for f in small]


def _cfg(**over):
    kw = dict(model_path="resnet18-seeded", model_type="resnet", input_size=[64, 64],
              resnet_num_classes=10, resnet_top_k=5, confidence_threshold=1e-6,
              precision="fp32", warmup=False, device="cpu", batch_buckets=[4],
              max_batch_size=4)
    kw.update(over)
    return kw


@pytest.mark.parametrize("host_resize", ["on", "off"])
@pytest.mark.parametrize("scores", ["raw", "softmax"])
def test_engine_matches_jax_engine(host_resize, scores):
    jm = jax_build_resnet("resnet18", 10)
    params = _np_tree(jm.init_params(jax.random.PRNGKey(0)))
    over = dict(host_resize=host_resize, resnet_scores=scores)
    jax_engine = JaxResNetEngine(JaxConfig(**_cfg(**over)), params=params)
    engine = TorchResNetEngine(DetectorConfig(**_cfg(**over)), params=params)
    frames = _frames()
    jp = [JaxPacket(stream=JaxStream(name=f"c{i}", url="x"), frame=f, frame_id=i, timestamp=0.0)
          for i, f in enumerate(frames)]
    tp = [FramePacket(stream=StreamConfig(name=f"c{i}", url="x"), frame=f, frame_id=i,
                      timestamp=0.0) for i, f in enumerate(frames)]
    _, resized = engine.host_prepare(frames, (120, 160))
    assert resized == (host_resize == "on")
    want, got = jax_engine.predict_packets(jp), engine.predict_packets(tp)
    tol = 1e-5 if scores == "softmax" else 2e-3
    for w, g in zip(want, got):
        assert [d.class_id for d in g] == [d.class_id for d in w]
        assert len(g) > 0
        np.testing.assert_allclose([d.confidence for d in g], [d.confidence for d in w],
                                   atol=tol, rtol=0)
        assert g[0].bbox_xyxy == (0.0, 0.0, 160.0, 120.0)


def test_create_detector_routes_resnet():
    engine = create_detector(DetectorConfig(**_cfg(model_path="absent-resnet18.pt")))
    assert isinstance(engine, TorchResNetEngine)
    assert engine.model.variant == "resnet18" and not engine._host_resize_active()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            create_detector(DetectorConfig(**_cfg(device="cuda")))
