"""A run whose timed path is broken underneath comes out not correct, once
for each fault a cell can have; the sound path and the program's own int8
path (the control) are run beside them. These runs skip the look for a
card and drive the rest of a run on the CPU at a small size."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import run as bench
from benchmark.tests.conftest import FOOTAGE_V8N, small_cell
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
from realtime_analytics_tpu_torch.types import BatchResult

SEED = 2**31 + 77


def broken_run_bucket(monkeypatch, alter):
    """Every step's padded result passes through ``alter(result, state)``
    where it is produced."""
    real = TorchYoloEngine._run_bucket
    state = {}

    def run_bucket(self, bucket, frames, src_hw, selected):
        res = real(self, bucket, frames, src_hw, selected)
        return alter(res, state)

    monkeypatch.setattr(TorchYoloEngine, "_run_bucket", run_bucket)


def half_batch(res, state):
    """The batch's second half left out: answered with the first half's results."""
    n = len(res.num_valid)
    idx = np.arange(n) % ((n + 1) // 2)
    return BatchResult(res.boxes_xyxy[idx], res.scores[idx], res.class_ids[idx],
                       res.num_valid[idx])


def stale(res, state):
    """The step returns its state unchanged: each call answers with the
    results of the last call of its size."""
    last = state.get(len(res.num_valid), res)
    state[len(res.num_valid)] = res
    return last


def relabelled(res, state):
    """An answer altered where it is produced: each detection's class."""
    return BatchResult(res.boxes_xyxy, res.scores, (res.class_ids + 1) % 80, res.num_valid)


def rescored(res, state):
    """An answer altered where it is produced: each detection's score."""
    return BatchResult(res.boxes_xyxy, res.scores * 0.7, res.class_ids, res.num_valid)


@pytest.mark.parametrize("name, config", [FOOTAGE_V8N, ("v8n-cams32", None)])
def test_sound_run_is_correct(name, config):
    res = bench.run_cell(small_cell(name, config), SEED, 2.0, False, "cpu")
    assert res["correct"], res["checks"]
    assert res["checks"]["frames"]["value"] >= 4


@pytest.mark.parametrize("fault", [half_batch, stale, relabelled, rescored])
@pytest.mark.parametrize("name, config", [FOOTAGE_V8N, ("v8n-cams32", None)])
def test_broken_step_is_not_correct(monkeypatch, name, config, fault):
    broken_run_bucket(monkeypatch, fault)
    res = bench.run_cell(small_cell(name, config), SEED, 2.0, False, "cpu")
    assert not res["correct"], (fault.__name__, res["checks"])


def test_cameras_with_results_sliced_to_the_wrong_frames(monkeypatch):
    real = TorchYoloEngine.predict_packets

    def rotated(self, packets):
        out = real(self, packets)
        return out[1:] + out[:1]  # each frame handed its neighbour's detections

    monkeypatch.setattr(TorchYoloEngine, "predict_packets", rotated)
    res = bench.run_cell(small_cell("v8n-cams32"), SEED, 2.0, False, "cpu")
    assert not res["correct"], res["checks"]


def test_control_int8_is_not_correct():
    cell = small_cell(*FOOTAGE_V8N)
    cell.kind().control(cell.config)
    assert cell.config["precision"] == "int8"
    res = bench.run_cell(cell, SEED, 2.0, False, "cpu")
    assert not res["correct"], res["checks"]
