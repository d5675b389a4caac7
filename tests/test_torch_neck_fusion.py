"""The port's neck fusion (``YoloModel.fuse_neck``) against its unfused
forward and against the JAX package's default (fused) forward.

Counterpart of tests/test_neck_fusion.py, at its tolerances: fused against
unfused, boxes rtol 1e-4 atol 2e-3 and scores rtol 1e-4 atol 1e-5 (exact
math up to accumulation order). Against JAX's ``YoloModel.apply`` with the
params carried across by ``params_from_jax``: tests/test_torch_model.py's
fp32 bounds (boxes atol 1e-3 px, conf atol 1e-5). The exported program of
a fused engine on the CPU is held against the live engine bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.models.yolo import build_yolo as j_build
from realtime_analytics_tpu_torch.models.layers import ConvAct
from realtime_analytics_tpu_torch.models.weights import (
    params_from_jax,
    quantize_params_int8,
    synthetic_params,
)
from realtime_analytics_tpu_torch.models.yolo import build_yolo


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers then do not oversubscribe the
    cores (several processes of 8 threads each on 8 cores slow down up to
    100-fold)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _carried(model_type, nc=16):
    jm = j_build(model_type, "n", nc)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tm = params_from_jax(build_yolo(model_type, "n", nc), tree).eval()
    tm.to(memory_format=torch.channels_last)
    return jm, jparams, tm


def _port(tm, x, reduce_scores):
    with torch.inference_mode():
        out = tm(torch.from_numpy(x), reduce_scores=reduce_scores)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("model_type", ["yolov8", "yolov5"])
def test_fused_neck_matches_unfused(model_type):
    _, _, tm = _carried(model_type)
    fus = tm._neck_fusions()
    assert len(fus) == 4, fus  # two (upsample, concat) junction pairs
    assert sorted(fus.values()) == ["cat", "cat", "up", "up"]
    x = np.random.default_rng(1).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)

    tm.fuse_neck = False
    plain = _port(tm, x, False)
    tm.fuse_neck = True
    fused = _port(tm, x, False)  # the weight halves split per call
    tm.prepare_neck()
    prepared = _port(tm, x, False)  # the halves kept by prepare_neck
    for got in (fused, prepared):
        np.testing.assert_allclose(got["boxes_xyxy"], plain["boxes_xyxy"],
                                   rtol=1e-4, atol=2e-3)
        np.testing.assert_allclose(got["scores"], plain["scores"], rtol=1e-4, atol=1e-5)


def test_fused_neck_does_not_materialize_the_upsample(monkeypatch):
    """A fused forward calls the split 1x1 once per C2f junction and
    upsamples only the split conv's output (cout channels, not the
    upsampled input's)."""
    from realtime_analytics_tpu_torch.models import layers, yolo

    tm = build_yolo("yolov8", "n", 8).eval()
    seen, calls = [], []
    real_up = layers.upsample2x

    def spy(t):
        seen.append(t.shape[1])
        return real_up(t)

    monkeypatch.setattr(yolo, "upsample2x", spy)
    monkeypatch.setattr(layers, "upsample2x", spy)
    real_split = ConvAct.up_concat
    monkeypatch.setattr(ConvAct, "up_concat",
                        lambda self, a, b: calls.append(1) or real_split(self, a, b))
    with torch.inference_mode():
        tm(torch.zeros(1, 64, 64, 3))
    assert len(calls) == 2
    # the cv1 outputs of nodes 12 and 15, not the 256- and 128-channel inputs
    assert seen == [tm.layers["12"].cv1.shape[0], tm.layers["15"].cv1.shape[0]]


def test_fusion_disabled_for_int8(monkeypatch):
    """int8 weights take the plain upsample + concat path (their activation
    scales are calibrated on the unsplit concat input)."""
    model = build_yolo("yolov8", "n", 8)
    params_from_jax(model, quantize_params_int8(synthetic_params(model, seed=0)))
    model.eval().to(memory_format=torch.channels_last)
    assert model.act_int8 and len(model._neck_fusions()) == 4
    model.prepare_neck()  # a no-op under int8
    assert all(getattr(m, "w_up", None) is None for m in model.modules())

    def refuse(*_a):
        raise AssertionError("the int8 forward took the fused neck")

    monkeypatch.setattr(ConvAct, "up_concat", refuse)
    with torch.inference_mode():
        out = model(torch.zeros(1, 64, 64, 3))
    assert out["boxes_xyxy"].shape[0] == 1


@pytest.mark.parametrize("model_type", ["yolov8", "yolov5"])
def test_fused_forward_matches_jax_default(model_type):
    jm, jparams, tm = _carried(model_type)
    assert jm.fuse_neck and tm.fuse_neck  # both packages' default
    tm.prepare_neck()
    x = np.random.default_rng(3).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    want = jm.apply(jparams, jnp.asarray(x), reduce_scores=True)
    got = _port(tm, x, True)
    np.testing.assert_allclose(got["boxes_xyxy"], np.asarray(want["boxes_xyxy"]), atol=1e-3)
    np.testing.assert_allclose(got["conf"], np.asarray(want["conf"]), atol=1e-5)
    assert np.mean(got["cls"] == np.asarray(want["cls"])) > 0.99  # near ties aside


def test_loading_weights_drops_the_kept_halves():
    """A new load makes the kept halves stale, so it drops them: the next
    forward splits the new weights."""
    tm = build_yolo("yolov8", "n", 8)
    tm.prepare_neck()
    assert tm.layers["12"].cv1.w_up is not None
    params_from_jax(tm, synthetic_params(tm, seed=3))
    assert tm.layers["12"].cv1.w_up is None and tm.layers["12"].cv1.w_skip is None


def test_fused_train_step_matches_jax():
    """The train step's forward with the neck fused (the step itself runs
    it layer by layer): the loss and every gradient leaf against
    JAX's fused ``value_and_grad`` at tests/test_torch_train.py's bounds
    (loss rtol 1e-5, relative L2 1e-4), autograd through the split 1x1
    convs' weight views."""
    from realtime_analytics_tpu.parallel import train as jtrain
    from realtime_analytics_tpu_torch.parallel import train

    hw, nc = (64, 64), 4
    jm = j_build("yolov8", "n", nc)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    anchors = jnp.asarray(jtrain.anchor_centers(hw))
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (2, *hw, 3)).astype(np.float32)
    targets = jtrain.synthetic_targets(rng, 2, 4, hw, nc)
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jtrain.detection_loss(jm, p, jnp.asarray(images),
                                        {k: jnp.asarray(v) for k, v in targets.items()},
                                        anchors)))(jparams)
    model = params_from_jax(build_yolo("yolov8", "n", nc),
                            jax.tree_util.tree_map(np.asarray, jparams))
    train.make_train_step(model, hw, device="cpu")
    assert not model.fuse_neck  # the step's own
    model.fuse_neck = True
    loss = train.detection_loss(model, torch.from_numpy(images),
                                {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()},
                                torch.from_numpy(train.anchor_centers(hw)))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = jax.tree_util.tree_leaves(
        train.named_tree(model, {n: p.grad for n, p in model.named_parameters()}))
    want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, want_grads))
    assert len(got) == len(want) > 100
    worst = max(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
                for g, w in zip(got, want))
    assert worst <= 1e-4, worst


def test_engines_fuse_on_the_card_only():
    """``fuse_neck_on``: an engine fuses its model's neck on the card and
    runs it layer by layer on the CPU."""
    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine, fuse_neck_on

    assert fuse_neck_on(torch.device("cuda", 0)) and not fuse_neck_on(torch.device("cpu"))
    eng = TorchYoloEngine(DetectorConfig(model_path="__random__.pt", device="cpu",
                                         input_size=[64, 64], warmup=False))
    assert not eng.model.fuse_neck and eng.model.layers["12"].cv1.w_up is None


def test_exported_program_serves_the_fused_forward(tmp_path):
    """A live engine with its neck fused and prepared (the card's default,
    set here on the CPU); its ``.rvae`` program takes the kept halves as
    inputs and serves what the live engine serves."""
    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
    from realtime_analytics_tpu_torch.engine.export import (
        ExportedYoloEngine,
        export_serving_artifact,
    )

    kw = dict(model_type="yolov8", device="cpu", input_size=[64, 64], batch_buckets=[2],
              max_batch_size=2, confidence_threshold=0.01, warmup=False,
              precision="fp32", num_classes=16)
    tree = synthetic_params(build_yolo("yolov8", "n", 16), seed=4)
    live = TorchYoloEngine(DetectorConfig(model_path="seeded", **kw), params=tree)
    live.model.fuse_neck = True
    live.model.prepare_neck()
    path = str(tmp_path / "fused.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(192, 192)])
    assert {"model/layers.15.cv1.w_up", "model/layers.15.cv1.w_skip"} <= set(meta["params"])
    served = ExportedYoloEngine(DetectorConfig(model_path=path, **kw))
    frames = np.random.default_rng(6).integers(0, 256, (2, 192, 192, 3), dtype=np.uint8)
    live.predict_arrays(frames)  # first call of a shape (see test_torch_export.py)
    want, got = live.predict_arrays(frames), served.predict_arrays(frames)
    assert int(want.num_valid.sum()) > 0
    for field in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
