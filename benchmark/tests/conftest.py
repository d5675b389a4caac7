"""Shared fixtures of the benchmark's CPU tests: its cells cut to a size the
CPU runs in seconds (320 input, 960 x 540 frames, a 3x pick as at 1080p ->
640), and a fixture that skips a test without a CUDA card."""

from __future__ import annotations

import pytest
import torch

from benchmark.cells import ROOT, load_cell, read_json

# the footage traffic with YOLOv8n: the footage driver's cheapest cell
FOOTAGE_V8N = ("v8l-footage-b32", "yolov8n-640-bf16")


def small_cell(name: str, config: str = None):
    """``name``, with the configuration ``config`` where given, on the same
    code paths at a CPU size."""
    cell = load_cell(name)
    if config:
        cell.config = read_json(ROOT / "configs" / f"{config}.json")
    cell.config["input_size"] = 320
    cell.mix.update(width=960, height=540)
    if cell.mix["driver"] == "cameras":
        cell.mix.update(cameras=3, fps=5, buckets=[2, 4], pool=4, ramp_seconds=1,
                        tail_seconds=1, check_frames=20)
    else:
        cell.mix.update(batch=4, pool=8, check_batches=2, warm_calls=1)
    return cell


@pytest.fixture(autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
