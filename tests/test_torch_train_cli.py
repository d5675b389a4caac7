"""The port's train CLI (``scripts/train.py``) on the CPU: the cases of
tests/test_train_cli.py, checkpoints that cross between the two packages,
and the resume file's layout.

Cross-loading: the two engines hold one checkpoint's weights bit for bit
and both serve it (equal detection counts; which near-tied boxes of a
barely trained model survive NMS is left to the engine tests).
"""

import contextlib
import io
import pickle
import re
import zipfile

import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource
from realtime_analytics_tpu_torch.scripts.train import main

TRAIN = ["--batch", "4", "--nc", "4", "--boxes-per-image", "2",
         "--input-size", "64", "64", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: training trajectories are chaotic in their
    rounding and the thread count changes it, so one thread gives the same
    run on every machine, and the test workers do not oversubscribe the
    cores (several training processes of 8 threads each on 8 cores slow
    down up to 100-fold)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _run(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _engine_cfg(cls_cfg, path, **over):
    kw = dict(model_path=str(path), model_type="yolov8", num_classes=4,
              input_size=[64, 64], warmup=False, precision="fp32",
              max_batch_size=1, batch_buckets=[1], pre_nms_topk=64,
              max_detections=8, confidence_threshold=0.001)
    kw.update(over)
    return cls_cfg(**kw)


def _torch_engine(path):
    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine

    return TorchYoloEngine(_engine_cfg(DetectorConfig, path, device="cpu"))


def _jax_engine(path):
    from realtime_analytics_tpu.config import DetectorConfig
    from realtime_analytics_tpu.engine.detector import JaxYoloEngine

    return JaxYoloEngine(_engine_cfg(DetectorConfig, path))


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    out = tmp_path_factory.mktemp("port") / "trained.npz"
    rc, text = _run(["--steps", "30", *TRAIN, "--log-every", "10", "--out", str(out),
                     "--seed", "1"])
    assert rc == 0 and out.exists()
    return out, [float(v) for v in re.findall(r"loss\s+([0-9.]+)", text)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """Two steps of the JAX trainer: its params checkpoint and its
    optax-state resume file."""
    from realtime_analytics_tpu.scripts.train import main as jax_main

    d = tmp_path_factory.mktemp("jax")
    out = d / "jax_trained.npz"
    assert jax_main(["--steps", "2", "--batch", "2", "--nc", "4", "--boxes-per-image", "2",
                     "--input-size", "64", "64", "--seed", "3", "--out", str(out),
                     "--checkpoint-dir", str(d / "ck")]) == 0
    return out, d / "ck" / "train_state.npz"


def _same_weights_and_serving(jax_eng, torch_eng, frames):
    """Both engines hold the checkpoint's weights bit for bit, and serve
    it: detections at conf 0.001 (a barely trained model scores near its
    class prior) with equal counts."""
    import jax

    from realtime_analytics_tpu_torch.models.weights import params_to_tree

    want = jax.tree_util.tree_map(np.asarray, jax_eng.params)
    got = params_to_tree(torch_eng.model)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for w, g in zip(jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(g, w)
    for frame in frames:
        ra, rb = jax_eng.predict_arrays(frame[None]), torch_eng.predict_arrays(frame[None])
        assert int(ra.num_valid[0]) == int(rb.num_valid[0]) > 0


def _frames(n=3):
    src = SyntheticSource(width=96, height=96, boxes=2, seed=9)
    return [src.read()[1] for _ in range(n)]


def test_read_labeled_boxes_match_rendered_pixels():
    src = SyntheticSource(width=160, height=120, boxes=3, seed=2)
    ok, frame, boxes, classes = src.read_labeled()
    assert ok and boxes.shape == (3, 4) and classes.tolist() == [0, 1, 2]
    for x1, y1, x2, y2 in boxes:
        assert 0 <= x1 < x2 <= 160 and 0 <= y1 < y2 <= 120
        cx, cy = int((x1 + x2) / 2), int((y1 + y2) / 2)
        # box centers land on bright rendered pixels, background stays dark
        assert frame[cy, cx].max() >= 120, "GT box center is not rendered"
    assert frame[0, 0].max() <= 24


def test_train_cli_decreases_loss_and_roundtrips(port_ckpt):
    out, losses = port_ckpt
    assert len(losses) == 4 and losses[-1] < losses[0], losses
    # the saved pytree loads straight into the serving engine
    eng = _torch_engine(out)
    br = eng.predict_arrays(_frames(1)[0][None])
    assert br.boxes_xyxy.shape[0] == 1  # runs end to end


def test_pytree_checkpoint_shape_mismatch_rejected(tmp_path):
    """A pytree checkpoint for a different architecture must be refused
    (fall back to random init), not silently mis-loaded."""
    import torch

    from realtime_analytics_tpu_torch.models.weights import (
        load_yolo_checkpoint,
        params_to_tree,
    )
    from realtime_analytics_tpu_torch.models.yolo import build_yolo

    small = build_yolo("yolov8", "n", nc=2)
    small.init_params(torch.Generator().manual_seed(0))
    path = tmp_path / "nc2.npz"
    np.savez(path, __pytree__=np.array(params_to_tree(small), dtype=object))

    assert load_yolo_checkpoint(build_yolo("yolov8", "n", nc=80), str(path)) is None
    assert load_yolo_checkpoint(build_yolo("yolov8", "n", nc=2), str(path)) is not None


def _tree(path):
    return np.load(path, allow_pickle=True)["__pytree__"].item()


def test_train_checkpoint_resume(tmp_path):
    """Crash-safe training: periodic full-state checkpoints (params +
    optimizer state + step) and --resume continuing the step count."""
    ckdir = str(tmp_path / "ck")
    common = ["--batch", "2", "--nc", "3", "--boxes-per-image", "1",
              "--input-size", "64", "64", "--log-every", "50",
              "--checkpoint-dir", ckdir, "--checkpoint-every", "3",
              "--seed", "2", "--device", "cpu"]
    out = str(tmp_path / "seed.npz")
    assert _run(["--steps", "6", "--out", out, *common])[0] == 0
    ck = tmp_path / "ck" / "train_state.npz"
    assert ck.exists()
    tree = _tree(ck)
    assert tree["step"] == 6 and tree["opt_state"]["count"] == 6
    assert set(tree["opt_state"]) == {"count", "mu", "nu"} and "params" in tree

    # --steps is the TOTAL budget: a crash-recovery rerun of the original
    # command line (--steps 10) completes steps 7..10, not 10 more. Also:
    # --init-from must NOT clobber a resumed checkpoint
    rc, text = _run(["--steps", "10", "--resume", "--init-from", out, *common])
    assert rc == 0 and "resumed from" in text and "at step 6" in text
    tree = _tree(ck)
    assert tree["step"] == 10 and tree["opt_state"]["count"] == 10

    # resuming at or past the budget performs no extra steps
    assert _run(["--steps", "10", "--resume", *common])[0] == 0
    assert _tree(ck)["step"] == 10


def test_resume_file_holds_no_pickled_class(tmp_path):
    ckdir = tmp_path / "ck"
    assert _run(["--steps", "2", *TRAIN, "--checkpoint-dir", str(ckdir),
                 "--checkpoint-every", "1"])[0] == 0
    with zipfile.ZipFile(ckdir / "train_state.npz") as zf:
        raw = zf.read("__pytree__.npy")
    seen = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add((module, name))
            return super().find_class(module, name)

    tree = Recorder(io.BytesIO(raw[raw.index(b"\n") + 1:])).load().item()  # after the header
    assert tree["step"] == 2 and tree["opt_state"]["count"] == 2
    # only numpy's array reconstruction: dicts, lists, ints and arrays
    assert seen and {name for _, name in seen} <= {"_reconstruct", "ndarray", "dtype"}
    assert {mod.split(".")[0] for mod, _ in seen} == {"numpy"}


def test_jax_resume_file_is_refused(jax_run, tmp_path, capsys):
    _, jax_state = jax_run
    ckdir = tmp_path / "ck"
    ckdir.mkdir()
    (ckdir / "train_state.npz").write_bytes(jax_state.read_bytes())
    rc = main(["--steps", "4", *TRAIN, "--checkpoint-dir", str(ckdir), "--resume"])
    assert rc == 1
    assert "not this trainer's resume layout" in capsys.readouterr().err


def test_port_checkpoint_serves_in_the_jax_engine(port_ckpt):
    out, _ = port_ckpt
    _same_weights_and_serving(_jax_engine(out), _torch_engine(out), _frames())


def test_jax_checkpoint_serves_in_the_port_and_seeds_training(jax_run, tmp_path):
    jax_out, _ = jax_run
    _same_weights_and_serving(_jax_engine(jax_out), _torch_engine(jax_out), _frames())
    # --init-from with no step to take writes the JAX tree back unchanged
    out = tmp_path / "seeded.npz"
    rc, text = _run(["--steps", "0", *TRAIN, "--init-from", str(jax_out), "--out", str(out)])
    assert rc == 0 and "nothing to do" in text
    import jax

    want, got = _tree(jax_out), _tree(out)
    leaves_w, leaves_g = jax.tree_util.tree_leaves(want), jax.tree_util.tree_leaves(got)
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for w, g in zip(leaves_w, leaves_g):
        np.testing.assert_array_equal(g, w)


def _losses(text):
    return [float(v) for v in re.findall(r"loss\s+([-\d.]+)", text)]


def test_mesh_trains_as_one_device(tmp_path):
    """``--mesh 4,2`` (4 x 2 entries of the CPU: each image a row, every
    conv's output channels over two ranks) takes the steps ``--mesh 1,1``
    takes: the global batch's loss at each step, as one device computes it
    (reduction order aside), and a checkpoint of the same tree."""
    runs = {}
    for mesh in ("1,1", "4,2"):
        out = tmp_path / f"mesh{mesh.replace(',', '')}.npz"
        rc, text = _run(["--steps", "2", "--log-every", "1", *TRAIN, "--mesh", mesh,
                         "--out", str(out)])
        assert rc == 0, text
        runs[mesh] = (_losses(text), _tree(out))
    (one, tree1), (eight, tree8) = runs["1,1"], runs["4,2"]
    assert len(one) == len(eight) == 2
    np.testing.assert_allclose(eight, one, rtol=1e-4)
    import jax

    leaves1, leaves8 = jax.tree_util.tree_leaves(tree1), jax.tree_util.tree_leaves(tree8)
    assert jax.tree_util.tree_structure(tree1) == jax.tree_util.tree_structure(tree8)
    assert all(a.shape == b.shape and np.isfinite(b).all() for a, b in zip(leaves1, leaves8))


def test_mesh_resume_continues_the_run(tmp_path):
    """A resume file written under ``--mesh 2,2`` resumes under ``2,2``
    (the sharded parameters and their moments scattered back from it) as
    under ``1,1``: the same loss at the resumed step, and the same moments
    in the file each run writes after it."""
    import shutil

    import jax

    made = tmp_path / "made"
    assert _run(["--steps", "1", *TRAIN, "--mesh", "2,2", "--checkpoint-dir", str(made)])[0] == 0
    runs = {}
    for mesh in ("2,2", "1,1"):
        ckpt = tmp_path / mesh.replace(",", "")
        shutil.copytree(made, ckpt)
        rc, text = _run(["--steps", "2", "--log-every", "1", *TRAIN, "--mesh", mesh,
                         "--checkpoint-dir", str(ckpt), "--resume"])
        assert rc == 0 and "resumed from" in text, text
        runs[mesh] = (_losses(text), _tree(ckpt / "train_state.npz"))
    (loss_m, state_m), (loss_1, state_1) = runs["2,2"], runs["1,1"]
    assert len(loss_m) == len(loss_1) == 1
    np.testing.assert_allclose(loss_m, loss_1, rtol=1e-4)
    assert state_m["step"] == state_1["step"] == 2
    assert state_m["opt_state"]["count"] == state_1["opt_state"]["count"] == 2
    for key in ("mu", "nu"):
        for a, b in zip(jax.tree_util.tree_leaves(state_1["opt_state"][key]),
                        jax.tree_util.tree_leaves(state_m["opt_state"][key])):
            np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-6)
