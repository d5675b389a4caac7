"""The port's YOLOv5 against the JAX package's, on the CPU.

Weights are carried across: the published-layout He-scaled yolov5n state
dict of scripts/gen_golden_fixture.py (``synthetic_weights_v5``, anchors
from the checkpoint) through both loaders, or a JAX ``init_params`` tree
for v5s. Bounds: the loaders' trees bit-equal; fp32 model outputs boxes
atol 2e-2 px (the anchor-scaled decode multiplies fp32 accumulation-order
differences by up to (2p)^2 * 373) and scores / conf atol 1e-5; bf16 at the
repo's bf16 fidelity bound (tests/test_bf16_fidelity.py: score delta <
0.02, median box drift < 1 px); the fp32 engines as tests/test_torch_engine.py
(num_valid and classes equal, boxes atol 1e-2 px, scores atol 1e-4).
"""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.engine.detector import JaxYoloEngine
from realtime_analytics_tpu.models.onnx_graph_model import cast_params_for_compute
from realtime_analytics_tpu.models.weights import (
    yolo_params_from_state_dict as j_from_sd,
)
from realtime_analytics_tpu.models.yolo import build_yolo as j_build
from realtime_analytics_tpu_torch.config import DetectorConfig
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine, create_detector
from realtime_analytics_tpu_torch.models.weights import (
    load_yolo_checkpoint,
    params_from_jax,
    params_to_tree,
    synthetic_params,
    yolo_params_from_state_dict,
)
from realtime_analytics_tpu_torch.models.yolo import (
    V5_ANCHORS,
    C3,
    DetectV5,
    build_yolo,
    size_from_model_path,
)
from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

from torch_mirror import TorchYoloMirror

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


def _assert_trees_equal(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for (path, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(got),
                                 jax.tree_util.tree_leaves_with_path(want), strict=True):
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(path))


@pytest.fixture(scope="module")
def v5_sd():
    sd = _fixture().synthetic_weights_v5()
    # a custom anchor set (stored divided by stride, as the published .pt)
    anchors = np.asarray(V5_ANCHORS, np.float32) * np.float32(1.25)
    sd["model.24.anchors"] = anchors / np.asarray([8, 16, 32], np.float32)[:, None, None]
    return sd


@pytest.fixture(scope="module")
def v5n_tree(v5_sd):
    return yolo_params_from_state_dict(build_yolo("yolov5", "n", 80), v5_sd)


# ---------------------------------------------------------------------------
# graph and loaders
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["n", "s"])
def test_v5_graph_matches_jax(size):
    jm, tm = j_build("yolov5", size, 80), build_yolo("yolov5", size, 80)
    assert tm.version == jm.version == 5
    assert [(n.kind, n.src, n.c2, n.k, n.s, n.p, n.n, n.shortcut) for n in tm.nodes] == [
        (n.kind, n.src, n.c2, n.k, n.s, n.p, n.n, n.shortcut) for n in jm.nodes]
    assert tm.channels == jm.channels and tm.detect_ch == jm.detect_ch
    assert tm.num_anchors((640, 640)) == jm.num_anchors((640, 640)) == 25200
    assert isinstance(tm.layers["2"], C3) and isinstance(tm.layers["24"], DetectV5)
    shapes = _np_tree(jax.tree_util.tree_map(np.shape, params_to_tree(tm)))
    want = jax.tree_util.tree_map(np.shape, _np_tree(jm.init_params(jax.random.PRNGKey(0))))
    assert shapes == want


def test_v5_state_dict_loader_gives_the_jax_tree(v5_sd, v5n_tree):
    """Both loaders on the published-layout state dict: the same tree
    exactly, anchors multiplied back to input pixels."""
    want = _np_tree(j_from_sd(j_build("yolov5", "n", 80), v5_sd))
    _assert_trees_equal(v5n_tree, want)
    np.testing.assert_array_equal(v5n_tree["layers"]["24"]["anchors"],
                                  np.asarray(V5_ANCHORS, np.float32) * np.float32(1.25))


def test_v5_loader_without_anchors_takes_the_defaults(v5_sd):
    sd = {k: v for k, v in v5_sd.items() if not k.endswith("anchors")}
    got = yolo_params_from_state_dict(build_yolo("yolov5", "n", 80), sd)
    _assert_trees_equal(got, _np_tree(j_from_sd(j_build("yolov5", "n", 80), sd)))
    np.testing.assert_array_equal(got["layers"]["24"]["anchors"],
                                  np.asarray(V5_ANCHORS, np.float32))


@pytest.mark.parametrize("fmt", ["pt", "flat_npz", "pytree_npz"])
def test_v5_checkpoint_formats_load_the_same_tree(tmp_path, v5_sd, v5n_tree, fmt):
    model = build_yolo("yolov5", "n", 80)
    path = tmp_path / ("w.pt" if fmt == "pt" else "w.npz")
    if fmt == "pt":
        torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in v5_sd.items()}, path)
    elif fmt == "flat_npz":
        np.savez(path, **v5_sd)
    else:
        np.savez(path, __pytree__=np.array(v5n_tree, dtype=object))
    _assert_trees_equal(load_yolo_checkpoint(model, str(path)), v5n_tree)


def test_v5_params_tree_round_trip(v5n_tree):
    model = params_from_jax(build_yolo("yolov5", "n", 80), v5n_tree)
    _assert_trees_equal(params_to_tree(model), v5n_tree)


def test_v5_synthetic_params_fit_and_keep_default_anchors():
    model = build_yolo("yolov5", "n", 80)
    a, b = synthetic_params(model, seed=0), synthetic_params(model, seed=0)
    _assert_trees_equal(a, b)
    assert (jax.tree_util.tree_map(np.shape, a)
            == jax.tree_util.tree_map(np.shape, params_to_tree(model)))
    np.testing.assert_array_equal(a["layers"]["24"]["anchors"],
                                  np.asarray(V5_ANCHORS, np.float32))
    params_from_jax(model, a)


def test_v5_init_biases_follow_the_jax_init():
    """The seeded module init: objectness log(8 / (640 / s)^2) and class
    log(0.6 / (nc - 0.999999)) biases, as the JAX ``_init_detect_v5``."""
    model = build_yolo("yolov5", "n", 16)
    model.init_params(torch.Generator().manual_seed(0))
    want = _np_tree(j_build("yolov5", "n", 16).init_params(jax.random.PRNGKey(0)))
    got = params_to_tree(model)
    for lvl in range(3):
        np.testing.assert_allclose(got["layers"]["24"]["m"][lvl]["b"],
                                   want["layers"]["24"]["m"][lvl]["b"], rtol=1e-6)
    np.testing.assert_array_equal(got["layers"]["24"]["anchors"],
                                  want["layers"]["24"]["anchors"])


def test_size_from_model_path_reads_v5_names():
    assert size_from_model_path("weights/yolov5s.pt") == "s"
    assert size_from_model_path("/x/yolov5m6.npz") == "m"


# ---------------------------------------------------------------------------
# the model against the JAX package's
# ---------------------------------------------------------------------------


def _outputs(tree, x, dtype, reduce_scores, size="n"):
    jm = j_build("yolov5", size, 80)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    if dtype == torch.bfloat16:  # the JAX bf16 engine's cast, anchors included
        jp = cast_params_for_compute(jp, jnp.bfloat16)
    jx = jnp.asarray(x).astype(jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    want = jax.jit(lambda p, v: jm.apply(p, v, reduce_scores=reduce_scores))(jp, jx)
    tm = params_from_jax(build_yolo("yolov5", size, 80), tree).eval()
    tm = tm.to(dtype=dtype, memory_format=torch.channels_last)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).to(dtype), reduce_scores=reduce_scores)
    conv = {k: (v.float().numpy() if v.is_floating_point() else v.numpy())
            for k, v in got.items()}
    return conv, {k: np.asarray(v.astype(jnp.float32) if v.dtype != jnp.int32 else v)
                  for k, v in want.items()}


@pytest.mark.parametrize("reduce_scores", [False, True])
@pytest.mark.parametrize("size", ["n", "s"])
def test_v5_fp32_matches_jax(v5n_tree, size, reduce_scores):
    tree = v5n_tree if size == "n" else _np_tree(
        j_build("yolov5", "s", 80).init_params(jax.random.PRNGKey(2)))
    x = np.random.default_rng(3).uniform(0, 1, (2, 96, 128, 3)).astype(np.float32)
    got, want = _outputs(tree, x, torch.float32, reduce_scores, size)
    assert got["boxes_xyxy"].shape == want["boxes_xyxy"].shape == (2, 3 * 252, 4)
    np.testing.assert_allclose(got["boxes_xyxy"], want["boxes_xyxy"], atol=2e-2)
    if reduce_scores:
        np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-5)
        assert got["cls"].dtype == np.int32
        assert np.mean(got["cls"] == want["cls"]) > 0.99  # near-tied logits aside
    else:
        np.testing.assert_allclose(got["scores"], want["scores"], atol=1e-5)


def test_v5_bf16_within_fidelity_bound(v5n_tree):
    x = np.random.default_rng(4).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    got, want = _outputs(v5n_tree, x, torch.bfloat16, True)
    assert np.abs(got["conf"] - want["conf"]).max() < 0.02
    assert np.median(np.abs(got["boxes_xyxy"] - want["boxes_xyxy"])) < 1.0


def test_v5_bf16_anchors_round_as_jax():
    """A reference quirk the port keeps: the bf16 engine casts the anchors
    with every float parameter, so the anchor 373 decodes as 372."""
    model = params_from_jax(build_yolo("yolov5", "n", 80),
                            synthetic_params(build_yolo("yolov5", "n", 80)))
    got = model.to(torch.bfloat16).layers["24"].anchors
    want = cast_params_for_compute(jnp.asarray(V5_ANCHORS, jnp.float32), jnp.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert float(got[2, 2, 0]) == 372.0


def test_v5_matches_the_ultralytics_layout_mirror():
    """The port's v5 against tests/torch_mirror.py's Ultralytics-layout
    module (BN unfolded), with the JAX package's bounds for its own v5
    (tests/test_yolo_fidelity.py: boxes atol 0.1 px, scores 2e-3)."""
    torch.manual_seed(3)
    mirror = TorchYoloMirror(j_build("yolov5", "n", nc=80)).eval()
    x = torch.rand(2, 3, 160, 160)
    want_boxes, want_scores = mirror(x)
    tree = yolo_params_from_state_dict(build_yolo("yolov5", "n", 80),
                                       mirror.ultralytics_state_dict())
    tm = params_from_jax(build_yolo("yolov5", "n", 80), tree).eval()
    with torch.inference_mode():
        got = tm(x.permute(0, 2, 3, 1).contiguous())
    np.testing.assert_allclose(got["boxes_xyxy"].numpy(), want_boxes.numpy(),
                               atol=1e-1, rtol=1e-3)
    np.testing.assert_allclose(got["scores"].numpy(), want_scores.numpy(),
                               atol=2e-3, rtol=1e-3)


def test_v5_reduce_scores_matches_full_decode(v5n_tree):
    tm = params_from_jax(build_yolo("yolov5", "n", 80), v5n_tree).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        full, red = tm(x), tm(x, reduce_scores=True)
    assert torch.equal(full["boxes_xyxy"], red["boxes_xyxy"])
    scores = full["scores"]
    torch.testing.assert_close(red["conf"], scores.amax(-1), rtol=1e-5, atol=1e-6)
    top = scores.gather(-1, red["cls"].long()[..., None])[..., 0]
    assert bool((top >= scores.amax(-1) - 1e-6).all())


def test_v5_stem_is_not_fused(v5n_tree):
    """The v5 stem is k6 s2 p2: the fused stem B3 refuses it, so pallas_stem
    on and off run the same layers."""
    tm = params_from_jax(build_yolo("yolov5", "n", 80), v5n_tree).eval()
    assert not tm.stem_nodes_ok() and not tm.stem_ok(640, 640, torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        off = tm(x, reduce_scores=True)
        tm.pallas_stem = tm.pallas_decode = "on"
        on = tm(x, reduce_scores=True)
    for k in off:
        assert torch.equal(off[k], on[k])


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def v5_npz(tmp_path_factory, v5_sd):
    path = tmp_path_factory.mktemp("w5") / "yolov5n_synthetic.npz"
    np.savez(path, **v5_sd)
    return str(path)


@pytest.fixture(scope="module")
def crops():
    scene = cv2.imread(os.path.join(REPO, "tests", "data", "golden_scene.png"))
    return np.stack([scene[y:y + 384, x:x + 384]
                     for y, x in ((300, 100), (500, 700), (600, 1200), (200, 1500))])


def _kw(path, **over):
    kw = dict(model_path=path, model_type="yolov5", device="cpu",
              confidence_threshold=0.25, warmup=False, input_size=[128, 128],
              max_batch_size=4, batch_buckets=[4], pre_nms_topk=256, precision="fp32")
    kw.update(over)
    return kw


def test_v5_engine_matches_jax(v5_npz, crops):
    """The selected step (3x pick, stem folded) of both engines on the same
    .npz: equal detections within the engine bounds."""
    want = JaxYoloEngine(JaxConfig(**_kw(v5_npz))).predict_arrays(crops)
    eng = TorchYoloEngine(DetectorConfig(**_kw(v5_npz)))
    assert eng.model.version == 5 and eng._stem_folded is None
    got = eng.predict_arrays(crops)
    assert want.num_valid.min() >= 5
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    for i, n in enumerate(want.num_valid):
        np.testing.assert_array_equal(got.class_ids[i, :n], want.class_ids[i, :n])
        np.testing.assert_allclose(got.boxes_xyxy[i, :n], want.boxes_xyxy[i, :n], atol=1e-2)
        np.testing.assert_allclose(got.scores[i, :n], want.scores[i, :n], atol=1e-4)


def test_v5_int8_engine_matches_jax(v5_npz, crops):
    """v5 under int8: int8 backbone and neck, the head weight-only
    (dequantised in bf16), anchors fp32. The selected step's model outputs
    (stem folded with a_scale * 255) against the JAX int8 engine's params
    and fold run op by op (see tests/test_torch_int8.py): conf within
    2e-3, classes equal on 99.9% of anchors, median box delta < 0.01 px.
    (This seeded v5 scores ~1000 anchors a frame within 0.30-0.37, so
    detections after NMS are held in the fp32 engine test instead.)"""
    kw = _kw(v5_npz, precision="int8")
    ref = JaxYoloEngine(JaxConfig(**kw))
    eng = TorchYoloEngine(DetectorConfig(**kw))
    head = eng.model.layers["24"]
    assert head.anchors.dtype == torch.float32 and head.m[0].w_q is not None
    assert head.m[0].a_scale is None  # the head conv is not calibrated
    sel, selected = eng.host_prepare(crops[:2], crops.shape[1:3])
    assert selected
    spec = letterbox_spec(crops.shape[1:3], eng.input_hw)
    with torch.inference_mode():
        x = eng._pad_cast(torch.from_numpy(sel), spec)
        got = eng._forward_selected(x)
    layers = dict(ref.params["layers"])
    stem = dict(layers["0"])  # JaxYoloEngine._build_step_selected's fold_stem
    stem["w_q"] = stem["w_q"][:, :, ::-1, :]
    stem["w_scale"] = stem["w_scale"] * (1.0 / 255.0)
    stem["a_scale"] = stem["a_scale"] * 255.0
    layers["0"] = stem
    with jax.disable_jit():
        want = ref.model.apply({**ref.params, "layers": layers},
                               jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                               reduce_scores=True)
    conf, wconf = got["conf"].numpy(), np.asarray(want["conf"])
    assert np.abs(conf - wconf).max() < 2e-3
    assert np.mean(got["cls"].numpy() == np.asarray(want["cls"])) > 0.999
    boxes, wboxes = got["boxes_xyxy"].numpy(), np.asarray(want["boxes_xyxy"])
    assert np.median(np.abs(boxes - wboxes)) < 1e-2
    res = eng.predict_arrays(crops[:2])
    assert (res.num_valid > 0).all() and np.isfinite(res.boxes_xyxy).all()


@pytest.mark.parametrize("precision", ["bf16", "fp32"])
def test_create_detector_serves_yolov5(v5_npz, crops, precision):
    eng = create_detector(DetectorConfig(**_kw(v5_npz, precision=precision)))
    assert isinstance(eng, TorchYoloEngine) and eng.model.version == 5
    res = eng.predict_arrays(crops[:3])
    assert res.boxes_xyxy.shape == (3, 300, 4) and (res.num_valid > 0).all()
    for i, n in enumerate(res.num_valid):
        bx = res.boxes_xyxy[i, :n]
        assert np.all(bx >= 0) and np.all(bx <= 384)


def test_v5_engine_params_unchanged_by_a_copy(v5n_tree):
    """The engine loads the tree without touching it (the anchors stay the
    checkpoint's)."""
    tree = copy.deepcopy(v5n_tree)
    TorchYoloEngine(DetectorConfig(**_kw("__given__.pt", input_size=[64, 64])),
                    params=tree)
    _assert_trees_equal(tree, v5n_tree)
