"""Temporal weights out of the port: ``temporal_state_dict_from_params`` and
``scripts/export_temporal_model.py``, against the JAX package's.

``temporal_state_dict_from_params`` gives the JAX function's arrays, name
for name and bit for bit, on the same numpy tree (numpy transposes both),
and inverts ``temporal_params_from_state_dict``. The port's export script
converts a torch checkpoint (``--from-torch``) into the same params tree and
the same torch-named ``.onnx`` bytes as the JAX package's script, writes
its seeded init, and ``--verify`` runs a clip through ``TorchTemporalEngine``
(here with ``--device cpu``).
"""

import jax
import numpy as np
import pytest
import torch

from realtime_analytics_tpu.models.temporal import build_temporal as jax_build_temporal
from realtime_analytics_tpu.models.weights import (
    temporal_state_dict_from_params as jax_temporal_state_dict_from_params,
)
from realtime_analytics_tpu.scripts.export_temporal_model import main as jax_main
from realtime_analytics_tpu_torch.models.temporal import build_temporal
from realtime_analytics_tpu_torch.models.weights import (
    load_temporal_checkpoint,
    temporal_params_from_state_dict,
    temporal_state_dict_from_params,
    temporal_synthetic_params,
)
from realtime_analytics_tpu_torch.scripts.export_temporal_model import main

FAMILIES = ["cnn_lstm", "conv_gru", "3d_cnn", "slow_fast"]
NC = 12


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _assert_trees_equal(a, b):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("model_type", FAMILIES)
def test_state_dict_from_params_equals_jax(model_type):
    params = _np_tree(jax_build_temporal(model_type, NC, "avg").init_params(
        jax.random.PRNGKey(3)))
    got = temporal_state_dict_from_params(build_temporal(model_type, NC, "avg"), params)
    want = jax_temporal_state_dict_from_params(jax_build_temporal(model_type, NC, "avg"),
                                               params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("model_type", FAMILIES)
def test_state_dict_round_trip(model_type):
    model = build_temporal(model_type, NC, "avg")
    params = temporal_synthetic_params(model, seed=4)
    sd = temporal_state_dict_from_params(model, params)
    _assert_trees_equal(temporal_params_from_state_dict(model, sd), params)


def _torch_checkpoint(model_type, path):
    """A torch-named checkpoint of the documented layout (seeded)."""
    model = build_temporal(model_type, NC, "avg")
    sd = temporal_state_dict_from_params(model, temporal_synthetic_params(model, seed=7))
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)


@pytest.mark.parametrize("model_type", ["cnn_lstm", "slow_fast"])
def test_from_torch_gives_the_jax_scripts_tree_and_bytes(model_type, tmp_path):
    ckpt = str(tmp_path / "ckpt.pt")
    _torch_checkpoint(model_type, ckpt)
    common = ["--model-type", model_type, "--num-classes", str(NC), "--from-torch", ckpt]
    assert main([*common, "--out", str(tmp_path / "port.npz")]) == 0
    assert jax_main([*common, "--out", str(tmp_path / "jax.npz")]) == 0
    got = np.load(tmp_path / "port.npz", allow_pickle=True)["__pytree__"].item()
    want = np.load(tmp_path / "jax.npz", allow_pickle=True)["__pytree__"].item()
    _assert_trees_equal(got, _np_tree(want))
    assert main([*common, "--out", str(tmp_path / "port.onnx")]) == 0
    assert jax_main([*common, "--out", str(tmp_path / "jax.onnx")]) == 0
    assert (tmp_path / "port.onnx").read_bytes() == (tmp_path / "jax.onnx").read_bytes()


def test_seeded_export_loads_and_verifies(tmp_path, capsys):
    out = str(tmp_path / "conv_gru.onnx")
    assert main(["--model-type", "conv_gru", "--num-classes", str(NC), "--seed", "5",
                 "--out", out, "--verify", "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    assert "wrote" in printed and "verify: clip produced 5 TemporalDetections" in printed
    model = build_temporal("conv_gru", NC, "avg")
    _assert_trees_equal(load_temporal_checkpoint(model, out),
                        temporal_synthetic_params(model, seed=5))
