"""On the card (marker ``cuda``; skips elsewhere): one short run of each
cell, run as `BENCHMARK.json` runs it, comes out correct with every metric it
reports; the control of the check fails it at each cell's own size."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark.cells import ROOT, load_cell

CELLS = json.loads((ROOT.parent / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", [w["name"] for w in CELLS])
def test_short_run_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", name, "--seed",
         str(2**31 + 11), "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    cell = load_cell(name)
    assert sorted(res["metrics"]) == sorted(cell.per_layer if trace else cell.end_to_end)
    assert res["device"]["kind"] == __import__("torch").cuda.get_device_name(0)


CONTROL_SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in CELLS])
def test_control_at_the_cells_size_is_not_correct(card, name):
    """The control (its model kind's ``control``: for YOLOv8 the program's
    own int8 path) at the cell's own size and load fails the check on three
    seeds, where the sound path passes on the same seeds; each run's
    readings are printed (``pytest -s``)."""
    from benchmark import run as bench

    bench.cache_env()
    seconds = 8.0 if load_cell(name).mix["driver"] == "cameras" else 5.0
    for seed in CONTROL_SEEDS:
        for control in (False, True):
            cell = load_cell(name)
            if control:
                cell.kind().control(cell.config)
            res = bench.run_cell(cell, seed, seconds, False, "cuda")
            checks = {k: c["value"] for k, c in res["checks"].items()}
            print(json.dumps({"cell": name, "seed": seed, "control": control,
                              "precision": cell.config.get("precision"),
                              "correct": res["correct"], "checks": checks}), flush=True)
            assert res["correct"] is not control, checks
