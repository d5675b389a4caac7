"""The benchmark finds its parts by name, agrees with ``BENCHMARK.json``,
freezes the right counts, and refuses to run where it must."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from benchmark import counts, run as bench
from benchmark.cells import ROOT, Cell, load_cell
from benchmark.reference.yolov8 import flops_per_image
from benchmark.tests.conftest import small_cell
from benchmark.weights import seeded_state_dict, yolov8_manifest

REPO = ROOT.parent
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())


def test_every_cell_of_the_spec_loads_with_its_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    configs = {c["name"]: c for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        cell = load_cell(w["name"])
        assert cell.chips == w["chips"]
        assert cell.config["name"] == w["config"] and w["config"] in configs
        assert (ROOT / "traffic" / f"{w['traffic']}.json").is_file()
        assert callable(cell.driver().run)
        want_e2e = [n for n, m in e2e.items() if w["name"] in m.get("workloads", [w["name"]])]
        want_layer = [n for n, m in per_layer.items()
                      if w["name"] in m.get("workloads", [w["name"]])]
        assert sorted(cell.end_to_end) == sorted(want_e2e)
        assert sorted(cell.per_layer) == sorted(want_layer)
        for name in cell.end_to_end + cell.per_layer:
            reader = cell.metric(name)
            unit = (e2e.get(name) or per_layer[name])["unit"]
            assert reader.UNIT == unit and callable(reader.read)
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file() and c["reduced"] == []


def test_a_cell_added_as_files_in_another_directory_runs(tmp_path):
    for sub in ("workloads", "configs", "traffic", "metrics"):
        (tmp_path / sub).mkdir()
    shutil.copy(ROOT / "configs" / "yolov8n-640-bf16.json", tmp_path / "configs")
    (tmp_path / "traffic" / "steady.json").write_text(json.dumps({"driver": "fixed", "n": 7}))
    (tmp_path / "traffic" / "fixed.py").write_text(textwrap.dedent("""
        def run(ctx):
            ctx.open_window()
            return {"window_s": ctx.seconds, "attempted": ctx.mix["n"], "failed": 0,
                    "things": ctx.mix["n"], "samples": []}
    """))
    (tmp_path / "metrics" / "things_per_s.py").write_text(textwrap.dedent("""
        UNIT = "things/s"

        def read(run):
            return run.readings["things"] / run.window_s
    """))
    (tmp_path / "workloads" / "new-cell.json").write_text(json.dumps({
        "config": "yolov8n-640-bf16", "traffic": "steady", "chips": 1,
        "end_to_end": ["things_per_s"], "per_layer": []}))
    cell = load_cell("new-cell", root=tmp_path)
    res = bench.run_cell(cell, 5, 2.0, False, "cpu")
    assert res["metrics"] == {"things_per_s": {"value": 3.5, "unit": "things/s"}}
    assert res["correct"] is False  # no frame compared
    assert list(res)[-1] == "checks"


TOY_KIND = """
    import json
    from pathlib import Path

    import torch


    def checkpoint(ctx):
        gen = torch.Generator().manual_seed(ctx.seed)
        ctx.state_dict = {"w": torch.rand(4, generator=gen)}
        path = str(Path(ctx.workdir) / "toy.pt")
        torch.save(ctx.state_dict, path)
        return path


    def detector_config(ctx, model_path, buckets, warmup):
        return {"path": model_path, "dtype": ctx.config["precision"], "batch": max(buckets)}


    def check(config, state_dict, samples, device):
        w = float(state_dict["w"].double().sum())
        gaps = [abs(y - x * w) for x, y in samples]
        out = {"gap": {"value": max(gaps, default=None), "limit": config["limit"]},
               "answers": {"value": len(samples), "limit": 1}}
        (Path(__file__).parents[1] / "last_checks.json").write_text(json.dumps(out))
        return out


    def passes(checks):
        gap, answers = checks["gap"], checks["answers"]
        return answers["value"] >= answers["limit"] and gap["value"] <= gap["limit"]


    def control(config):
        config["precision"] = "float16"
"""

TOY_DRIVER = """
    import torch


    def run(ctx):
        mix = ctx.mix
        settings = ctx.detector_config(ctx.checkpoint(), [mix["batch"]], warmup=False)
        w = torch.load(settings["path"])["w"].to(getattr(torch, settings["dtype"]))
        ctx.open_window()
        xs = torch.arange(mix["n"], dtype=w.dtype) + 0.5
        ys = xs * w.sum()
        samples = [(float(x), float(y) + mix["alter"]) for x, y in zip(xs, ys)]
        return {"window_s": ctx.seconds, "attempted": mix["n"], "failed": 0,
                "answers": len(samples), "samples": samples}
"""


def toy_root(root: Path) -> Path:
    """A benchmark root of new files only: a configuration of the kind
    ``toy``, its kind, a driver, a mix, a cell and a metric."""
    for sub in ("workloads", "configs", "traffic", "metrics", "kinds"):
        (root / sub).mkdir()
    (root / "configs" / "toy-1.json").write_text(json.dumps(
        {"name": "toy-1", "kind": "toy", "precision": "float32", "limit": 1e-4}))
    (root / "kinds" / "toy.py").write_text(textwrap.dedent(TOY_KIND))
    (root / "traffic" / "toy.py").write_text(textwrap.dedent(TOY_DRIVER))
    (root / "traffic" / "toy-8.json").write_text(json.dumps(
        {"driver": "toy", "n": 8, "batch": 4, "alter": 0}))
    (root / "metrics" / "answers_per_s.py").write_text(textwrap.dedent("""
        UNIT = "answers/s"

        def read(run):
            return run.readings["answers"] / run.window_s
    """))
    (root / "workloads" / "toy-cell.json").write_text(json.dumps({
        "config": "toy-1", "traffic": "toy-8", "chips": 1,
        "end_to_end": ["answers_per_s"], "per_layer": []}))
    return root


@pytest.mark.parametrize("fault, correct", [(None, True), ("altered", False),
                                            ("control", False)])
def test_a_model_of_another_kind_added_as_files_decides_correct(tmp_path, fault, correct):
    cell = load_cell("toy-cell", root=toy_root(tmp_path))
    if fault == "altered":
        cell.mix["alter"] = 1e-3  # each answer altered where the driver produces it
    elif fault == "control":
        cell.kind().control(cell.config)
    res = bench.run_cell(cell, 2**31 + 41, 2.0, False, "cpu")
    assert res["correct"] is correct, res["checks"]
    assert res["checks"] == json.loads((tmp_path / "last_checks.json").read_text())
    assert res["checks"]["answers"]["value"] == 8
    assert res["metrics"] == {"answers_per_s": {"value": 4.0, "unit": "answers/s"}}


def test_a_configuration_without_a_kind_is_refused(tmp_path):
    cell = load_cell("toy-cell", root=toy_root(tmp_path))
    del cell.config["kind"]
    with pytest.raises(ValueError, match="names no kind"):
        bench.run_cell(cell, 1, 1.0, False, "cpu")


KIND_PARTS = ("checkpoint", "detector_config", "check", "passes", "control")


@pytest.mark.parametrize("path", sorted((ROOT / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_each_configuration_names_a_kind_with_its_parts(path):
    config = json.loads(path.read_text())
    kind = Cell(config["name"], config, {}, [], []).kind()
    assert (ROOT / "kinds" / f"{config['kind']}.py").is_file()
    for part in KIND_PARTS:
        assert callable(getattr(kind, part)), part


@pytest.mark.parametrize("name", ["run.py", "cells.py"])
def test_the_harness_imports_nothing_of_a_model(name):
    model_parts = {"reference", "yolov8", "weights", "compare"}
    for node in ast.walk(ast.parse((ROOT / name).read_text())):
        if isinstance(node, ast.ImportFrom):
            named = set((node.module or "").split(".")) | {a.name for a in node.names}
        elif isinstance(node, ast.Import):
            named = {part for a in node.names for part in a.name.split(".")}
        else:
            continue
        assert not named & model_parts, ast.dump(node)


YOLO_SEED = 2**31 + 19


@pytest.fixture(scope="module")
def yolo_samples(tmp_path_factory):
    """YOLOv8n at the CPU size of ``small_cell``, seeded weights, and the
    frames and served detections of one ``predict_arrays`` call on 4
    textured and 4 flat scenes; with them the same detections rescored and
    relabelled."""
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine

    from benchmark.frames import scene_frames

    config = small_cell("v8n-cams32").config
    kind = load_cell("v8n-cams32").kind()
    ctx = SimpleNamespace(config=config, seed=YOLO_SEED, device="cpu",
                          workdir=str(tmp_path_factory.mktemp("yolo")), state_dict=None)
    engine = TorchYoloEngine(kind.detector_config(ctx, kind.checkpoint(ctx), [8], False))
    gen = torch.Generator().manual_seed(YOLO_SEED + 1)
    frames = torch.cat([scene_frames(gen, 4, "cpu", (540, 960)),
                        scene_frames(gen, 4, "cpu", (540, 960), field=0, noise=0)]).numpy()
    res = engine.predict_arrays(frames)
    sound = []
    for i in range(len(frames)):
        k = int(res.num_valid[i])
        sound.append((i, frames[i], res.boxes_xyxy[i, :k], res.scores[i, :k],
                      res.class_ids[i, :k]))
    sets = {"sound": sound,
            "rescored": [(i, f, b, s * 0.7, c) for i, f, b, s, c in sound],
            "relabelled": [(i, f, b, s, (c + 1) % 80) for i, f, b, s, c in sound]}
    return kind, config, ctx.state_dict, sets


# what the check read, on these samples, before it moved into kinds/yolov8.py
RECORDED_CHECKS = {
    "sound": ({"served_off": {"value": 0.0, "limit": 8.0},
               "missed": {"value": 0.0, "limit": 6.0},
               "frames": {"value": 8, "limit": 1}}, True),
    "rescored": ({"served_off": {"value": 34.78260869565217, "limit": 8.0},
                  "missed": {"value": 44.44444444444444, "limit": 6.0},
                  "frames": {"value": 8, "limit": 1}}, False),
    "relabelled": ({"served_off": {"value": 100.0, "limit": 8.0},
                    "missed": {"value": 0.0, "limit": 6.0},
                    "frames": {"value": 8, "limit": 1}}, False),
}


@pytest.mark.parametrize("samples", sorted(RECORDED_CHECKS))
def test_yolov8_check_reads_what_it_read_in_run(yolo_samples, samples):
    kind, config, state_dict, sets = yolo_samples
    checks = kind.check(config, state_dict, sets[samples], "cpu")
    want, passes = RECORDED_CHECKS[samples]
    assert checks == want
    assert kind.passes(checks) is passes


@pytest.mark.parametrize("scale, published", [("n", 8.743e9), ("l", 165.2e9)])
def test_frozen_flops(scale, published):
    cfg = load_cell("v8n-cams32" if scale == "n" else "v8l-footage-b32").config
    counted = flops_per_image(seeded_state_dict(scale, 0, "cpu"), cfg["input_size"])
    assert cfg["flops_per_image"] == counted
    assert abs(counted / published - 1) < 0.03


def test_manifest_is_the_programs():
    from realtime_analytics_tpu_torch.scripts.gen_yolo_manifest import yolov8_manifest as theirs

    for scale in "nsmlx":
        assert yolov8_manifest(scale) == theirs(scale)


@pytest.mark.parametrize("scale, widths, gflop, mbytes", [
    ("n", (16, 32), 10.3809, 131.072),  # chip_smoke's B3 row: 10.4 GFLOP, 131 MB
    ("l", (64, 128), 132.1205, 288.358),
])
def test_stem_roofline_counts(scale, widths, gflop, mbytes):
    assert counts.stem_widths(scale) == widths
    flops, nbytes = counts.stem_work(32, 640, 640, *widths, 2)
    assert flops / 1e9 == pytest.approx(gflop, rel=1e-5)
    assert nbytes / 1e6 == pytest.approx(mbytes, rel=1e-5)


@pytest.mark.parametrize("k, pairs, ms", [
    (512, 4_194_304, 0.000751),  # chip_smoke's B6 row: 4.19 M pairs at N = 32
    (1024, 16_777_216, 0.003005),  # the configurations' pre-NMS top-k
])
def test_nms_roofline_counts(k, pairs, ms):
    ops, nbytes = counts.nms_work(32, k)
    assert ops == 12 * pairs
    kind = "NVIDIA H100 80GB HBM3"
    assert counts.roofline_time(ops, nbytes, kind, "fp32") * 1e3 == pytest.approx(ms, rel=1e-3)
    assert counts.roofline_time(ops, nbytes, "some other card", "fp32") is None


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    for name in ("realtime_analytics_tpu_torch.ops", "jaxtyping", "benchmark.jax"):
        monkeypatch.setitem(sys.modules, name, sys)
    for name in [m for m in sys.modules if m.split(".")[0] in bench.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    assert bench.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "realtime_analytics_tpu.engine", sys)
    assert bench.forbidden_modules() == ["jax", "realtime_analytics_tpu"]


def _python(code: str, cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_and_the_reference_load_no_forbidden_module():
    code = textwrap.dedent("""
        import sys
        import benchmark.reference.yolov8, benchmark.compare
        assert not [m for m in sys.modules if m.split('.')[0].startswith('realtime_analytics')]
        from benchmark import run
        from benchmark.tests.conftest import FOOTAGE_V8N, small_cell
        res = run.run_cell(small_cell(*FOOTAGE_V8N), 3, 1.0, False, 'cpu')
        assert res['correct'], res
        print(run.forbidden_modules())
    """)
    out = _python(code, REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_it_exits_with_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "v8l-footage-b32", "--seed",
         str(2**31 + 7), "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_without_the_program_it_exits_with_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *SPEC["command"][1:], "--workload", "v8n-cams32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


def test_seeded_weights_repeat_and_differ():
    a, b = seeded_state_dict("n", 2**31 + 5, "cpu"), seeded_state_dict("n", 2**31 + 5, "cpu")
    c = seeded_state_dict("n", 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["model.0.conv.weight"], c["model.0.conv.weight"])
    assert sorted(a) == sorted(yolov8_manifest("n"))
