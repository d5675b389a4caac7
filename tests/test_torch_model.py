"""The port's YOLOv8n module against the JAX package's ``YoloModel.apply``.

Weights are carried across (JAX ``init_params(PRNGKey(0))`` -> numpy ->
``params_from_jax``), inputs are made with numpy. Bounds: fp32 boxes atol
1e-3 px and conf atol 1e-5 (accumulation order only); bf16 at the bound of
tests/test_bf16_fidelity.py (score delta < 0.02, median box drift < 1 px).
"""

import copy
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.models.weights import (
    yolo_params_from_state_dict as j_from_sd,
)
from realtime_analytics_tpu.models.yolo import build_yolo as j_build
from realtime_analytics_tpu_torch.models.weights import (
    params_from_jax,
    params_to_tree,
    yolo_params_from_state_dict,
)
from realtime_analytics_tpu_torch.models.yolo import build_yolo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def carried():
    jm = j_build("yolov8", "n", nc=80)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    tm = params_from_jax(build_yolo("yolov8", "n", 80), tree).eval()
    return jm, jparams, tm, tree


def _run(jm, jparams, tm, x, dtype, stem="off", decode="off"):
    jp = jax.tree_util.tree_map(lambda a: a.astype(dtype), jparams)
    want = jm.apply(jp, jnp.asarray(x, dtype=dtype), reduce_scores=True)
    tdt = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    tm = copy.deepcopy(tm).to(dtype=tdt, memory_format=torch.channels_last)
    tm.pallas_stem, tm.pallas_decode = stem, decode
    with torch.inference_mode():
        got = tm(torch.from_numpy(x).to(tdt), reduce_scores=True)
    return ({k: v.float().numpy() if v.is_floating_point() else v.numpy()
             for k, v in got.items()},
            {k: np.asarray(v.astype(jnp.float32) if v.dtype != jnp.int32 else v)
             for k, v in want.items()})


@pytest.mark.parametrize("stem,decode", [("off", "off"), ("on", "on")])
def test_v8n_fp32_matches_jax(carried, stem, decode):
    jm, jparams, tm, _ = carried
    x = np.random.default_rng(3).uniform(0, 1, (2, 128, 128, 3)).astype(np.float32)
    got, want = _run(jm, jparams, tm, x, jnp.float32, stem, decode)
    assert got["boxes_xyxy"].shape == want["boxes_xyxy"].shape == (2, 336, 4)
    np.testing.assert_allclose(got["boxes_xyxy"], want["boxes_xyxy"], atol=1e-3)
    np.testing.assert_allclose(got["conf"], want["conf"], atol=1e-5)
    assert np.mean(got["cls"] == want["cls"]) > 0.99  # near-tied logits aside


def test_v8n_bf16_within_fidelity_bound(carried):
    jm, jparams, tm, _ = carried
    x = np.random.default_rng(4).uniform(0, 1, (1, 128, 128, 3)).astype(np.float32)
    got, want = _run(jm, jparams, tm, x, jnp.bfloat16, "on", "on")
    assert np.abs(got["conf"] - want["conf"]).max() < 0.02
    assert np.median(np.abs(got["boxes_xyxy"] - want["boxes_xyxy"])) < 1.0


def test_params_tree_round_trip(carried):
    _, _, tm, tree = carried
    back = params_to_tree(tm)
    flat_a = jax.tree_util.tree_leaves(back)
    flat_b = jax.tree_util.tree_leaves(tree)
    assert len(flat_a) == len(flat_b)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_array_equal(a, b)


def test_ultralytics_loader_gives_the_jax_tree():
    spec = importlib.util.spec_from_file_location(
        "gen_golden_fixture", os.path.join(REPO, "scripts", "gen_golden_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    sd = fixture.synthetic_weights()
    got = yolo_params_from_state_dict(build_yolo("yolov8", "n", 80), sd)
    want = j_from_sd(j_build("yolov8", "n", 80), sd)
    assert (jax.tree_util.tree_structure(got)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, want)))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("fmt", ["pt", "ultralytics_pt", "flat_npz", "pytree_npz"])
def test_checkpoint_formats_load_the_same_tree(tmp_path, fmt):
    from realtime_analytics_tpu_torch.models.weights import load_yolo_checkpoint

    spec = importlib.util.spec_from_file_location(
        "gen_golden_fixture", os.path.join(REPO, "scripts", "gen_golden_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    sd = fixture.synthetic_weights()
    model = build_yolo("yolov8", "n", 80)
    want = yolo_params_from_state_dict(model, sd)
    path = tmp_path / ("w.pt" if fmt.endswith("pt") else "w.npz")
    tensors = {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}
    if fmt == "pt":
        torch.save(tensors, path)
    elif fmt == "ultralytics_pt":
        torch.save({"model": {k.removeprefix("model."): v for k, v in tensors.items()}},
                   path)
    elif fmt == "flat_npz":
        np.savez(path, **sd)
    else:
        np.savez(path, __pytree__=np.array(want, dtype=object))
    got = load_yolo_checkpoint(model, str(path))
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    # a weights-.onnx reads its initializers; a file that is not there is
    # no checkpoint (tests/test_torch_onnx_lite.py holds real ones)
    assert load_yolo_checkpoint(model, str(tmp_path / "w.onnx")) is None


def test_synthetic_params_fit_the_module_and_are_seeded():
    from realtime_analytics_tpu_torch.models.weights import synthetic_params

    model = build_yolo("yolov8", "n", 80)
    a, b = synthetic_params(model, seed=0), synthetic_params(model, seed=0)
    c = synthetic_params(model, seed=1)
    shapes = jax.tree_util.tree_map(np.shape, params_to_tree(model))
    assert jax.tree_util.tree_map(np.shape, a) == shapes
    for x, y, z in zip(*(jax.tree_util.tree_leaves(t) for t in (a, b, c))):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(x, y)
        assert not np.array_equal(x, z)
    params_from_jax(model, a)  # loads without a shape complaint
