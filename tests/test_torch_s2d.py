"""The port's space-to-depth early backbone (``models/s2d.py``) on the CPU.

Counterpart of tests/test_s2d_backbone.py, case for case and at its
tolerances, each case also held against the JAX package's function on the
same inputs: the port's tensors are NCHW (channels_last memory) where the
JAX package's are NHWC, its weights OIHW where JAX's are HWIO. The
scattered weights are bit-equal to JAX's (the phase matrices are 0/1); the
s2d convs agree with the plain conv and with JAX's at atol 2e-5, rtol
1e-5; the s2d forward with the plain forward and with JAX's at atol 1e-3,
rtol 1e-4; the engine's s2d detections with its plain ones and with the
JAX engine's s2d ones at boxes atol 0.5 px, scores atol 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.models import s2d as jax_s2d
from realtime_analytics_tpu.models.yolo import build_yolo as jax_build_yolo
from realtime_analytics_tpu_torch.models.layers import conv_act
from realtime_analytics_tpu_torch.models.s2d import (
    depth_to_space,
    s2d_conv_act,
    s2d_conv_weight,
    space_to_depth,
)
from realtime_analytics_tpu_torch.models.weights import params_from_jax
from realtime_analytics_tpu_torch.models.yolo import build_yolo


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _nchw(a: np.ndarray) -> torch.Tensor:
    """An NHWC array as the port's NCHW tensor in channels_last memory."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def test_s2d_roundtrip(rng):
    x = rng.normal(size=(2, 16, 24, 5)).astype(np.float32)
    for f in (2, 4):
        y = space_to_depth(_nchw(x), f)
        assert tuple(y.shape) == (2, 5 * f * f, 16 // f, 24 // f)
        assert y.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(_nhwc(depth_to_space(y, f)), x)
        np.testing.assert_array_equal(_nhwc(y), np.asarray(jax_s2d.space_to_depth(x, f)))


def test_s2d_channel_order(rng):
    """Channel-major (c*f^2 + py*f + px): splitting s2d channels in half
    splits the original channels in half, the C2f/C3 contract."""
    x = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    y = space_to_depth(_nchw(x), 2)
    a, b = y.chunk(2, dim=1)
    np.testing.assert_array_equal(_nhwc(depth_to_space(a, 2)), x[..., :2])
    np.testing.assert_array_equal(_nhwc(depth_to_space(b, 2)), x[..., 2:])
    ja, jb = jnp.split(jax_s2d.space_to_depth(x, 2), 2, axis=-1)
    np.testing.assert_array_equal(_nhwc(a), np.asarray(ja))
    np.testing.assert_array_equal(_nhwc(b), np.asarray(jb))


@pytest.mark.parametrize(
    "k,stride,pad,fi,fo",
    [
        (3, 2, None, 4, 2),  # v8 stem
        (6, 2, 2, 4, 2),  # v5 stem
        (3, 2, None, 2, 2),  # P2 conv
        (1, 1, None, 2, 2),  # block 1x1 (phase-diagonal)
        (3, 1, None, 2, 2),  # bottleneck 3x3
        (3, 2, None, 2, 1),  # exit conv (s2d -> normal)
    ],
)
def test_s2d_conv_matches_plain(rng, k, stride, pad, fi, fo):
    from realtime_analytics_tpu.models.layers import conv_act as jax_conv_act

    ci, co, h = 3, 8, 16
    w = (rng.normal(size=(k, k, ci, co)) * 0.3).astype(np.float32)  # HWIO
    b = rng.normal(size=(co,)).astype(np.float32)
    x = rng.normal(size=(2, h, h, ci)).astype(np.float32)
    w_t = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))  # OIHW
    b_t = torch.from_numpy(b)
    ref = conv_act(_nchw(x), w_t, b_t, stride=stride, padding=pad)
    got = s2d_conv_act(space_to_depth(_nchw(x), fi), w_t, b_t, fi=fi, fo=fo, stride=stride,
                       pad=pad)
    got = depth_to_space(got, fo) if fo > 1 else got
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=1e-5)
    # the scattered weight is JAX's, bit for bit; the conv agrees with JAX's
    wp, sp, padding = s2d_conv_weight(w_t, fi, fo, stride, pad)
    jwp, jsp, jpadding = jax_s2d.s2d_conv_weight(jnp.asarray(w), fi, fo, stride, pad)
    assert (sp, padding) == (jsp, jpadding)
    np.testing.assert_array_equal(wp.permute(2, 3, 1, 0).numpy(), np.asarray(jwp))
    p = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    want = jax_s2d.s2d_conv_act(p, jax_s2d.space_to_depth(jnp.asarray(x), fi), fi=fi, fo=fo,
                                stride=stride, pad=pad)
    want = jax_s2d.depth_to_space(want, fo) if fo > 1 else want
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(_nhwc(ref), np.asarray(jax_conv_act(p, jnp.asarray(x),
                               stride=stride, padding=pad)), atol=2e-5, rtol=1e-5)


def _models(model_type):
    """The port's model and the JAX model on JAX's init, carried across."""
    jm = jax_build_yolo(model_type, "n", nc=80)
    params = jm.init_params(jax.random.PRNGKey(0))
    m = build_yolo(model_type, "n", 80)
    params_from_jax(m, jax.tree_util.tree_map(np.asarray, params)).eval().to(
        memory_format=torch.channels_last)
    return m, jm, params


@pytest.mark.parametrize("model_type", ["yolov8", "yolov5"])
def test_s2d_full_model_equivalence(model_type):
    m, jm, params = _models(model_type)
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (1, 64, 64, 3), jnp.float32))
    xt = torch.from_numpy(x)
    assert m._s2d_prefix_ok()
    with torch.no_grad():
        ref = m(xt)
        out = m(xt, s2d=True)
        m.prepare_s2d()
        prepared = m(xt, s2d=True)
    jm.s2d_backbone = True
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), ref[key].numpy(), atol=1e-3, rtol=1e-4)
        np.testing.assert_array_equal(prepared[key].numpy(), out[key].numpy())
        np.testing.assert_allclose(out[key].numpy(), np.asarray(want[key]), atol=1e-3,
                                   rtol=1e-4)


def test_s2d_skipped_for_unaligned_input():
    """The JAX case's 32x36 input serves with s2d asked for (no crash), and
    equals JAX's output."""
    m, jm, params = _models("yolov8")
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(1), (1, 32, 36, 3), jnp.float32))
    with torch.no_grad():
        out = m(torch.from_numpy(x), s2d=True)
    assert out["boxes_xyxy"].shape[0] == 1
    jm.s2d_backbone = True
    want = jax.jit(jm.apply)(params, jnp.asarray(x))
    np.testing.assert_allclose(out["scores"].numpy(), np.asarray(want["scores"]), atol=1e-3,
                               rtol=1e-4)


def _engine_cfg(mode, port):
    from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
    from realtime_analytics_tpu_torch.config import DetectorConfig

    kw = dict(model_path="missing.pt", model_type="yolov8", input_size=[64, 64],
              max_batch_size=2, batch_buckets=[2], precision="fp32",
              confidence_threshold=0.0015, warmup=False, s2d_backbone=mode)
    return DetectorConfig(device="cpu", **kw) if port else JaxConfig(**kw)


def _hold_engine(got, ref):
    np.testing.assert_array_equal(ref.num_valid, got.num_valid)
    for i in range(len(ref.num_valid)):
        k = int(ref.num_valid[i])
        np.testing.assert_array_equal(ref.class_ids[i, :k], got.class_ids[i, :k])
        np.testing.assert_allclose(got.boxes_xyxy[i, :k], ref.boxes_xyxy[i, :k], atol=0.5)
        np.testing.assert_allclose(got.scores[i, :k], ref.scores[i, :k], atol=5e-3)


def test_engine_s2d_on_matches_off(rng):
    """Engine level: forced-on s2d gives the plain path's detections, and
    the JAX engine's forced-on s2d ones on the same params and frames."""
    from realtime_analytics_tpu.engine.detector import JaxYoloEngine
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine

    frames = rng.integers(0, 256, size=(2, 96, 128, 3), dtype=np.uint8)
    jax_on = JaxYoloEngine(_engine_cfg("on", port=False))
    tree = jax.tree_util.tree_map(np.asarray, jax_on.params)

    def run(mode):
        eng = TorchYoloEngine(_engine_cfg(mode, port=True), params=tree)
        assert eng._s2d_for_bucket(2) == (mode == "on")
        return eng.predict_arrays(frames)

    ref, got = run("off"), run("on")
    assert int(ref.num_valid.sum()) > 0
    _hold_engine(got, ref)
    _hold_engine(got, jax_on.predict_arrays(frames))


def test_s2d_bucket_policy():
    """JAX's policy: auto is decided per bucket on a single-chip TPU only,
    so it is off on the CPU and on the card at every bucket; on and off
    hold at every bucket. The port's decision equals the JAX engine's on
    the CPU for each mode and bucket."""
    from realtime_analytics_tpu.engine.detector import JaxYoloEngine
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine

    for mode in ("auto", "on", "off"):
        eng = TorchYoloEngine(_engine_cfg(mode, port=True))
        jeng = JaxYoloEngine(_engine_cfg(mode, port=False))
        for b in (16, 32, 64, 128):
            assert eng._s2d_for_bucket(b) == jeng._s2d_for_bucket(b) == (mode == "on")
        eng.device = torch.device("cuda", 0)  # the decision reads no card
        assert eng._s2d_for_bucket(16) == (mode == "on")
