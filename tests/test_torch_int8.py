"""The port's native int8 against the JAX package's, on the CPU.

Quantisation (``quantize_params_int8``) is numpy in both packages: the
port's ``w_q`` and ``w_scale`` must be bit-identical to JAX's. The int8
convolution (the port: im2col + ``torch._int_mm``; JAX: XLA's
``conv_general_dilated`` on int8 operands) must give the same int32
accumulators exactly, with static and with dynamic activation scales.
Calibration (``calibrate_int8_activations`` on ``_calibration_frames``)
must give each conv's ``a_scale`` within rtol 1e-3 of JAX's: the int8
convs agree exactly, so only the last fp32 bits of SiLU differ. The
engines, int8 at 192x192 on the same He-scaled weights and golden-scene
crops, must give the same detections (IoU > 0.6, same class, score within
0.02) as the JAX engine run op by op, and 80% of the compiled JAX engine's
(XLA keeps excess precision across fused int8 convs). The module tests
hold the port's int8 forward (dynamic and calibrated static scales)
against JAX's and against its own fp32 forward with the JAX package's
tolerances (tests/test_int8.py).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.engine import detector as jdet
from realtime_analytics_tpu.engine.detector import JaxYoloEngine
from realtime_analytics_tpu.models import weights as jweights
from realtime_analytics_tpu.models.yolo import build_yolo as j_build
from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
from realtime_analytics_tpu_torch.engine import detector as tdet
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine, create_detector
from realtime_analytics_tpu_torch.models.layers import ConvAct
from realtime_analytics_tpu_torch.models.weights import (
    calibrate_int8_activations,
    params_from_jax,
    params_to_tree,
    quantize_params_int8,
    yolo_params_from_state_dict,
)
from realtime_analytics_tpu_torch.models.yolo import build_yolo
from realtime_analytics_tpu_torch.ops.int8 import (
    QuantConv,
    conv2d_int8,
    conv2d_int8_acc,
    im2col_int8,
    pack_int8_weight,
)
from realtime_analytics_tpu_torch.types import FramePacket

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fixture():
    spec = importlib.util.spec_from_file_location(
        "gen_golden_fixture", os.path.join(REPO, "scripts", "gen_golden_fixture.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _leaves(tree):
    return jax.tree_util.tree_leaves_with_path(tree)


@pytest.fixture(scope="module")
def v8_tree():
    return _np_tree(j_build("yolov8", "n", nc=80).init_params(jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def golden_sd():
    return _fixture().synthetic_weights()


@pytest.fixture(scope="module")
def crops():
    scene = cv2.imread(os.path.join(REPO, "tests", "data", "golden_scene.png"))
    return np.stack([scene[y:y + 576, x:x + 576] for y, x in ((250, 80), (450, 1200))])


# ---------------------------------------------------------------------------
# quantisation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model_type", ["yolov8", "yolov5"])
def test_quantized_tree_is_bit_identical_to_jax(model_type):
    tree = _np_tree(j_build(model_type, "n", nc=80).init_params(jax.random.PRNGKey(1)))
    want = _np_tree(jweights.quantize_params_int8(tree))
    got = quantize_params_int8(tree)
    assert (jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want))
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_quantized_tree_shapes_and_dtypes(v8_tree):
    node = quantize_params_int8(v8_tree)["layers"]["0"]
    assert node["w_q"].dtype == np.int8 and "w" not in node
    assert node["w_scale"].shape == (node["w_q"].shape[-1],)
    assert node["w_scale"].dtype == node["b"].dtype == np.float32


def test_int8_tree_round_trips_through_the_module(v8_tree):
    q = quantize_params_int8(v8_tree)
    q["layers"]["0"]["a_scale"] = np.float32(0.0123)
    model = params_from_jax(build_yolo("yolov8", "n", 80), q)
    stem = model.layers["0"]
    assert stem.weight is None and stem.w_q.dtype == torch.int8
    assert stem.a_scale.dtype == torch.float32 and stem.w_pack.shape == (16, 32)
    back = params_to_tree(model)
    assert (jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(q))
    for (path, a), (_, b) in zip(_leaves(back), _leaves(q), strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    with pytest.raises(ValueError, match="int8 weights"):
        params_from_jax(model, v8_tree)


# ---------------------------------------------------------------------------
# the int8 convolution
# ---------------------------------------------------------------------------

# (batch, h, w, cin, cout, k, stride, padding): the v8 stem (K 27 -> 32),
# a 3x3 at a v8n width, a strided 3x3 at C 64, a 1x1 whose cout pads to 8,
# the v5 stem (k6 s2 p2, K 108 -> 112) and a conv with M <= 16 (rows padded)
CONVS = {
    "v8_stem": (2, 32, 32, 3, 16, 3, 2, None),
    "c3x3_16": (2, 20, 20, 16, 16, 3, 1, None),
    "c3x3_64_s2": (1, 16, 16, 64, 128, 3, 2, None),
    "c1x1_24_20": (2, 9, 7, 24, 20, 1, 1, None),
    "v5_stem": (2, 32, 32, 3, 16, 6, 2, 2),
    "tiny_m": (1, 4, 4, 32, 8, 3, 2, None),
}


def _conv_case(name, seed):
    n, h, w, cin, cout, k, s, p = CONVS[name]
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (n, h, w, cin)).astype(np.float32)
    wf = rng.normal(0, np.sqrt(2.0 / (k * k * cin)), (k, k, cin, cout)).astype(np.float32)
    node = quantize_params_int8({"w": wf, "b": rng.normal(0, 0.1, cout).astype(np.float32)})
    return x, node, k, s, p


def _jax_acc(x, node, k, s, p, act_scale):
    """The accumulators of JAX's ``conv2d_int8``: its quantisation lines and
    its ``conv_general_dilated`` call."""
    pad = k // 2 if p is None else p
    x_f = jnp.asarray(x)
    if act_scale is None:
        act_scale = jnp.maximum(jnp.max(jnp.abs(x_f)), 1e-8) / 127.0
    xq = jnp.clip(jnp.round(x_f / act_scale), -127, 127).astype(jnp.int8)
    acc = jax.lax.conv_general_dilated(
        xq, jnp.asarray(node["w_q"]), window_strides=(s, s),
        padding=((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return np.asarray(acc), np.asarray(xq)


def _port_quant(node, a_scale):
    w_q = torch.from_numpy(node["w_q"].transpose(3, 2, 0, 1).copy())
    return w_q, QuantConv(pack_int8_weight(w_q), torch.from_numpy(node["w_scale"]),
                          None if a_scale is None else torch.tensor(a_scale))


@pytest.mark.parametrize("scale", ["static", "dynamic"])
@pytest.mark.parametrize("name", sorted(CONVS))
def test_int8_conv_accumulators_equal_jax(name, scale):
    x, node, k, s, p = _conv_case(name, seed=len(name))
    a_scale = np.float32(np.abs(x).max() * 0.8 / 127.0) if scale == "static" else None
    want, _ = _jax_acc(x, node, k, s, p, a_scale)
    w_q, q = _port_quant(node, a_scale)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    acc, used = conv2d_int8_acc(xt, q, w_q.shape[0], k, stride=s, padding=p)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == want.shape
    np.testing.assert_array_equal(acc.numpy(), want)
    if scale == "static":
        assert used is q.a_scale
    else:
        np.testing.assert_array_equal(
            used.numpy(), np.asarray(jnp.maximum(jnp.max(jnp.abs(x)), 1e-8) / 127.0))
    # the dequantised output against JAX's conv2d_int8 itself: the same
    # accumulators, scales and bias; fp32 rounding of the last op aside
    from realtime_analytics_tpu.models.layers import conv2d_int8 as j_conv2d_int8

    j_out = np.asarray(j_conv2d_int8(
        jnp.asarray(x), jnp.asarray(node["w_q"]), jnp.asarray(node["w_scale"]),
        jnp.asarray(node["b"]), stride=s, padding=p,
        act_scale=None if a_scale is None else jnp.asarray(a_scale)))
    got = conv2d_int8(xt, q, torch.from_numpy(node["b"]), w_q.shape[0], k, stride=s,
                      padding=p).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, j_out, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["v8_stem", "v5_stem", "tiny_m", "c1x1_24_20"])
def test_im2col_product_equals_a_float64_conv(name):
    """The K order (ky, kx, cin) of the im2col rows against the packed
    weight: the int32 product equals a float64 convolution of the same
    int8 operands; padded rows and columns are zero."""
    x, node, k, s, p = _conv_case(name, seed=7)
    pad = k // 2 if p is None else p
    xq = torch.from_numpy(np.clip(np.round(x * 40), -127, 127).astype(np.int8))
    w_q = torch.from_numpy(node["w_q"].transpose(3, 2, 0, 1).copy())
    pack = pack_int8_weight(w_q)
    assert pack.shape[0] % 8 == 0 and pack.shape[1] % 8 == 0
    a, (n, ho, wo) = im2col_int8(xq, k, s, pad, pack.shape[1])
    m = n * ho * wo
    assert a.shape[0] >= max(m, 17) and not a[m:].any()
    assert not a[:, k * k * x.shape[-1]:].any()
    acc = torch._int_mm(a, pack.t())[:m, :w_q.shape[0]]
    want = F.conv2d(xq.permute(0, 3, 1, 2).double(), w_q.double(), stride=s, padding=pad)
    np.testing.assert_array_equal(acc.reshape(n, ho, wo, -1).numpy(),
                                  want.permute(0, 2, 3, 1).numpy().astype(np.int64))


# ---------------------------------------------------------------------------
# the module's int8 forward
# ---------------------------------------------------------------------------


def _module(tree):
    """The port's module on a params tree: a quantised tree runs the int8
    convs, a float one the float convs."""
    model = params_from_jax(build_yolo("yolov8", "n", 8), tree).eval()
    return model.to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def small_tree():
    return _np_tree(j_build("yolov8", "n", nc=8).init_params(jax.random.PRNGKey(4)))


def _calibrated(tree, x):
    """``tree`` quantised, with every conv's ``a_scale`` calibrated by the
    JAX package on ``x``."""
    jm = j_build("yolov8", "n", nc=8)
    jm.act_int8 = True
    jq = jweights.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    jweights.calibrate_int8_activations(jm, jq, [jnp.asarray(x)])
    return _np_tree(jq)


@pytest.mark.parametrize("scale", ["dynamic", "static"])
def test_int8_forward_matches_jax(small_tree, scale):
    """The int8 forward with dynamic scales, and with static scales that
    JAX calibrated, on fp32 inputs against JAX's ``apply`` with
    ``act_int8`` on the same quantised tree: boxes within 0.05 px, scores
    within 2e-3."""
    jm = j_build("yolov8", "n", nc=8)
    jm.act_int8 = True
    x = np.random.default_rng(5).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    q = quantize_params_int8(small_tree) if scale == "dynamic" else _calibrated(small_tree, x)
    want = jm.apply(jax.tree_util.tree_map(jnp.asarray, q), jnp.asarray(x))
    model = _module(q)
    assert model.act_int8
    assert all((m.a_scale is None) == (scale == "dynamic")
               for m in model.modules() if isinstance(m, ConvAct))
    with torch.inference_mode():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got["boxes_xyxy"].numpy(), np.asarray(want["boxes_xyxy"]),
                               atol=5e-2)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]), atol=2e-3)


@pytest.mark.parametrize("scale", ["dynamic", "static"])
def test_int8_forward_close_to_fp32(small_tree, scale):
    """The JAX package's own bounds (tests/test_int8.py): scores
    correlate > 0.99 with the fp32 forward, boxes within 4 px at 64x64,
    with dynamic scales and with static ones calibrated on the input."""
    x = np.random.default_rng(2).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    model = _module(quantize_params_int8(small_tree))
    if scale == "static":
        calibrate_int8_activations(model, [x], torch.device("cpu"))
    with torch.inference_mode():
        ref = _module(small_tree)(torch.from_numpy(x))
        got = model(torch.from_numpy(x))
    r = np.corrcoef(got["scores"].numpy().ravel(), ref["scores"].numpy().ravel())[0, 1]
    assert r > 0.99
    np.testing.assert_allclose(got["boxes_xyxy"].numpy(), ref["boxes_xyxy"].numpy(), atol=4.0)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def test_calibration_frames_equal_jax():
    got = tdet._calibration_frames((192, 192))
    want = jdet._calibration_frames((192, 192))
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape == (1, 192, 192, 3)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("model_type,hw", [("yolov8", 64), ("yolov5", 64)])
def test_calibrated_scales_match_jax(model_type, hw, golden_sd):
    """The same float tree, quantised and calibrated on the same frames by
    each package: every conv_act conv gets an ``a_scale``, within rtol 1e-3
    of JAX's; the v5 head conv gets none in either. (Most scales come out
    bit-equal; one int8 level that flips on a last-bit SiLU difference
    shifts every later dynamic scale a little.)"""
    if model_type == "yolov8":
        tree = yolo_params_from_state_dict(build_yolo("yolov8", "n", 80), golden_sd)
    else:
        tree = yolo_params_from_state_dict(build_yolo("yolov5", "n", 80),
                                           _fixture().synthetic_weights_v5())
    frames = tdet._calibration_frames((hw, hw))
    jm = j_build(model_type, "n", nc=80)
    jm.act_int8 = True
    jq = jweights.quantize_params_int8(jax.tree_util.tree_map(jnp.asarray, tree))
    jweights.calibrate_int8_activations(jm, jq, [jnp.asarray(f) for f in frames])
    want = _np_tree(jq)
    model = params_from_jax(build_yolo(model_type, "n", 80), quantize_params_int8(tree))
    baked = calibrate_int8_activations(model.eval(), frames, torch.device("cpu"))
    got = params_to_tree(model)
    pairs = [(p, a, b) for (p, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True)
             if "a_scale" in jax.tree_util.keystr(p)]
    n_convs = sum(1 for m in model.modules() if isinstance(m, ConvAct))
    assert baked == len(pairs) == n_convs - (3 if model_type == "yolov5" else 0)
    for path, a, b in pairs:
        assert np.asarray(a).dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=jax.tree_util.keystr(path))


def test_calibration_failure_raises(monkeypatch):
    """The JAX engine serves with dynamic scales when calibration fails;
    the port's engine raises."""
    def broken(*_a, **_k):
        raise RuntimeError("no calibration frames")

    monkeypatch.setattr(tdet, "_calibration_frames", broken)
    with pytest.raises(RuntimeError, match="no calibration frames"):
        TorchYoloEngine(DetectorConfig(model_path="__random__.pt", device="cpu",
                                       warmup=False, input_size=[64, 64],
                                       precision="int8"))


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _kw(**over):
    kw = dict(model_path="__int8__.pt", device="cpu", confidence_threshold=0.25,
              warmup=False, input_size=[192, 192], max_batch_size=2, batch_buckets=[2],
              pre_nms_topk=256, max_detections=64, precision="int8")
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def int8_engines(golden_sd):
    tree = yolo_params_from_state_dict(build_yolo("yolov8", "n", 80), golden_sd)
    port = TorchYoloEngine(DetectorConfig(**_kw()), params=tree)
    ref = JaxYoloEngine(JaxConfig(**_kw()),
                        params=jax.tree_util.tree_map(jnp.asarray, tree))
    return port, ref, tree


def _iou(a, b):
    tl, br = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = np.prod(np.clip(br - tl, 0, None))
    ua, ub = np.prod(np.clip(a[2:] - a[:2], 0, None)), np.prod(np.clip(b[2:] - b[:2], 0, None))
    return inter / max(ua + ub - inter, 1e-9)


def _matched(got, want, i, score_tol, k=None):
    """How many of frame i's first k reference detections have a
    counterpart: same class, IoU > 0.6, score within ``score_tol``."""
    k = int(want.num_valid[i]) if k is None else min(k, int(want.num_valid[i]))
    hits = 0
    for r in range(k):
        hits += any(got.class_ids[i, g] == want.class_ids[i, r]
                    and _iou(got.boxes_xyxy[i, g], want.boxes_xyxy[i, r]) > 0.6
                    and abs(got.scores[i, g] - want.scores[i, r]) < score_tol
                    for g in range(int(got.num_valid[i])))
    return hits, k


def test_int8_engine_params_and_scales_match_jax(int8_engines):
    """The engine's tree: w_q and w_scale as JAX's, biases, scales and
    anchors left in fp32 (the JAX int8 engine skips the compute-dtype
    cast), every conv calibrated, a_scale within rtol 1e-3."""
    port, ref, _ = int8_engines
    assert port.compute_dtype == torch.bfloat16 and port.model.act_int8
    got, want = params_to_tree(port.model), _np_tree(ref.params)
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want), strict=True):
        key = jax.tree_util.keystr(path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, key
        if "a_scale" in key:
            np.testing.assert_allclose(a, b, rtol=1e-3, err_msg=key)
        else:
            np.testing.assert_array_equal(a, b, err_msg=key)
    assert all(m.a_scale is not None for m in port.model.modules() if isinstance(m, ConvAct))


@pytest.mark.parametrize("mode", ["eager", "jit"])
def test_int8_engine_matches_jax(int8_engines, crops, mode):
    """int8 detections at 192x192 (selected step, exact 3x pick, stem
    folded with a_scale * 255). Against the JAX engine run op by op (its
    code's own semantics, which the port follows operation for operation):
    equal counts, and every JAX detection has a port counterpart with IoU
    > 0.6, the same class and a score within 0.02. Against the compiled
    JAX engine at least 80% do, counts within 2: XLA keeps excess
    precision across fused int8 convs (a conv quantises the unrounded fp32
    SiLU of its producer, not the bf16 value the code writes), which moves
    scores by up to 0.002 and reorders near-tied detections (ROADMAP.md
    Queue C)."""
    port, ref, _ = int8_engines
    if mode == "eager":
        with jax.disable_jit():
            want = ref.predict_arrays(crops)
    else:
        want = ref.predict_arrays(crops)
    got = port.predict_arrays(crops)
    assert port.host_prepare(crops, crops.shape[1:3])[1]
    assert want.num_valid.min() >= 5
    for i in range(len(crops)):
        hits, k = _matched(got, want, i, score_tol=0.02)
        if mode == "eager":
            assert got.num_valid[i] == want.num_valid[i] and hits == k, f"frame {i}: {hits}/{k}"
        else:
            assert abs(int(got.num_valid[i]) - int(want.num_valid[i])) <= 2
            assert hits >= 0.8 * k, f"frame {i}: {hits}/{k} JAX detections matched"


def test_int8_close_to_the_bf16_engine(int8_engines, crops):
    """The JAX package's int8 accuracy gate (tests/test_int8.py:85) on the
    port: at least 70% of the bf16 engine's top-8 detections have an int8
    counterpart with the same class, IoU > 0.6 and a score within 0.1."""
    port, _, tree = int8_engines
    bf16 = TorchYoloEngine(DetectorConfig(**_kw(precision="bf16")), params=tree)
    ref, got = bf16.predict_arrays(crops), port.predict_arrays(crops)
    for i in range(len(crops)):
        hits, k = _matched(got, ref, i, score_tol=0.1, k=8)
        assert k > 0 and hits >= max(1, int(0.7 * k)), f"frame {i}: {hits}/{k}"


def test_int8_stem_fold_equals_jax(int8_engines):
    """The selected step's int8 stem: ``w_q`` with its input channels
    flipped, ``w_scale / 255`` and ``a_scale * 255``, as JAX's fold_stem."""
    port, ref, _ = int8_engines
    stem = ref.params["layers"]["0"]
    folded = port._w0_folded
    w_q = torch.from_numpy(np.asarray(stem["w_q"])[:, :, ::-1, :].transpose(3, 2, 0, 1).copy())
    assert torch.equal(folded.w_pack, pack_int8_weight(w_q))
    np.testing.assert_array_equal(folded.w_scale.numpy(),
                                  np.asarray(stem["w_scale"] * (1.0 / 255.0)))
    np.testing.assert_allclose(folded.a_scale.numpy(), np.asarray(stem["a_scale"] * 255.0),
                               rtol=1e-3)
    assert port._stem_folded is None and not port.model.stem_ok(192, 192, torch.bfloat16)


def test_int8_host_select_path_matches_int8_full_path(golden_sd):
    """The selected step (raw pixels, a_scale * 255) against the
    device-resize step (RGB [0, 1], the plain stem) on the same calibrated
    engine weights: the JAX package's test_int8.py:162 bounds."""
    tree = yolo_params_from_state_dict(build_yolo("yolov8", "n", 80), golden_sd)
    kw = _kw(input_size=[64, 64], confidence_threshold=0.01, max_detections=16,
             pre_nms_topk=64)
    sel = TorchYoloEngine(DetectorConfig(host_select="auto", **kw), params=tree)
    off = TorchYoloEngine(DetectorConfig(host_select="off", **kw), params=tree)
    for a, b in zip(params_to_tree(sel.model)["layers"].values(),
                    params_to_tree(off.model)["layers"].values()):
        for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
            np.testing.assert_array_equal(x, y)
    frames = np.random.default_rng(3).integers(0, 256, (2, 192, 192, 3), dtype=np.uint8)
    assert sel.host_prepare(frames, (192, 192))[1] and not off.host_prepare(frames, (192, 192))[1]
    got, want = sel.predict_arrays(frames), off.predict_arrays(frames)
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    np.testing.assert_allclose(got.scores, want.scores, atol=0.02)
    np.testing.assert_allclose(got.boxes_xyxy, want.boxes_xyxy, atol=4.0)


@pytest.mark.parametrize("model_type", ["yolov8", "yolov5"])
def test_create_detector_serves_int8(model_type):
    eng = create_detector(DetectorConfig(
        model_path="__random__.pt", model_type=model_type, device="cpu", warmup=False,
        input_size=[64, 64], max_batch_size=2, batch_buckets=[2], precision="int8",
        confidence_threshold=0.005, pre_nms_topk=64, max_detections=16))
    assert isinstance(eng, TorchYoloEngine) and eng.model.act_int8
    frame = np.random.default_rng(0).integers(0, 256, (96, 128, 3), np.uint8)
    dets = eng.predict(FramePacket(StreamConfig(name="s", url="mem://"), frame, 0, 0.0))
    assert isinstance(dets, list)
    for d in dets:
        assert 0 <= d.bbox_xyxy[0] <= d.bbox_xyxy[2] <= 128.1


def test_int8_calibration_only_records_when_asked():
    """Calibration hooks every conv for its pass alone: a forward outside
    it bakes no scale, and no hook stays behind."""
    model = build_yolo("yolov8", "n", 8)
    model.init_params(torch.Generator().manual_seed(0))
    params_from_jax(model, quantize_params_int8(params_to_tree(model)))
    convs = [m for m in model.modules() if isinstance(m, ConvAct)]
    with torch.inference_mode():
        model(torch.rand(1, 64, 64, 3))
    assert all(m.a_scale is None for m in convs)
    assert calibrate_int8_activations(model, [np.random.default_rng(0).uniform(
        0, 1, (1, 64, 64, 3)).astype(np.float32)], torch.device("cpu")) == len(convs)
    assert all(m.a_scale is not None and not m._forward_pre_hooks for m in convs)
