"""The port's evaluator (a copy of the JAX package's numpy module) and its
eval CLI on the CPU.

The copied metrics must equal JAX's exactly (same numpy code, same
inputs): seeded random samples, NaN where both have NaN. The CLI runs the
synthetic smoke of tests/test_eval_metrics.py through ``TorchYoloEngine``
with ``--device cpu``.
"""

import contextlib
import io
import json
import math

import numpy as np
import pytest

from realtime_analytics_tpu.eval import detection_metrics as jm
from realtime_analytics_tpu_torch.eval import detection_metrics as tm


def _boxes(rng, n):
    xy = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(4, 60, (n, 2))
    return np.concatenate([xy, xy + wh], axis=1).astype(np.float32)


def _samples(mod, seed, n_images=6, nc=3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_images):
        n_gt, n_det = rng.integers(0, 6), rng.integers(0, 10)
        gt = _boxes(rng, n_gt)
        # half the detections jitter a GT box, the rest land anywhere
        det = _boxes(rng, n_det)
        for i in range(min(n_gt, n_det // 2)):
            det[i] = gt[i] + rng.normal(0, 3, 4).astype(np.float32)
        out.append(mod.DetectionSample(
            det_boxes=det, det_scores=rng.uniform(0, 1, n_det),
            det_classes=rng.integers(0, nc, n_det), gt_boxes=gt,
            gt_classes=rng.integers(0, nc, n_gt)))
    return out


def _equal(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _equal(a[k], b[k])
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b)
    else:
        assert a == b


@pytest.mark.parametrize("seed", range(4))
def test_metrics_equal_jax_on_seeded_samples(seed):
    got = tm.evaluate_detections(_samples(tm, seed))
    want = jm.evaluate_detections(_samples(jm, seed))
    assert got["n_gt"] > 0 and got["n_detections"] > 0
    _equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_match_and_ap_equal_jax(seed):
    rng = np.random.default_rng(100 + seed)
    gt, det = _boxes(rng, 5), _boxes(rng, 9)
    det[:4] = gt[:4] + rng.normal(0, 2, (4, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, 9)
    np.testing.assert_array_equal(tm.iou_matrix(det, gt), jm.iou_matrix(det, gt))
    for thr in (0.5, 0.75):
        tp = tm.match_detections(det, scores, gt, thr)
        np.testing.assert_array_equal(tp, jm.match_detections(det, scores, gt, thr))
        assert tm.average_precision(tp, scores, 5) == jm.average_precision(tp, scores, 5)


def test_eval_cli_synthetic_smoke():
    """Full CLI path: synthetic labeled frames through a real (random-init)
    engine on the CPU; metrics come out well-formed."""
    from realtime_analytics_tpu_torch.scripts.eval_detections import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--model-path", "/nonexistent-random-init.pt",
            "--synthetic", "4",
            "--synthetic-hw", "64", "96",
            "--input-size", "64", "64",
            "--batch", "4",
            "--json",
            "--device", "cpu",
        ])
    assert rc == 0
    metrics = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert metrics["n_images"] == 4
    assert metrics["n_gt"] == 16  # 4 boxes per synthetic frame


def test_eval_cli_device_overrides_config(tmp_path):
    """--device overrides the config's device; a config asking for the card
    raises on a machine without one (no silent CPU fallback)."""
    import torch

    from realtime_analytics_tpu_torch.scripts.eval_detections import main

    cfg = tmp_path / "c.yaml"
    cfg.write_text("detector:\n  model_path: /nonexistent.pt\n  device: cuda\n"
                   "  input_size: [64, 64]\nstreams:\n  - name: cam\n    url: synthetic://\n")
    argv = ["--config", str(cfg), "--synthetic", "2", "--synthetic-hw", "64", "96",
            "--batch", "2", "--json"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv + ["--device", "cpu"]) == 0
    assert json.loads(buf.getvalue().strip().splitlines()[-1])["n_images"] == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            main(argv)
