"""The clip cell (``sf50-clips-b32``): SlowFast R50's model kind, the clip
driver and the clip readers, on the CPU at a small size (depths [1, 1, 1, 1],
slow width 16, 8 frames at stride 2 of 32 x 32, 4 clips a call): the
program builds that spec in place of the published one."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import clip_counts, run as bench
from benchmark.cells import ROOT, load_cell
from benchmark.reference.slowfast import SlowFast, flops_per_clip, logits, manifest
from benchmark.slowfast_weights import seeded_state_dict

CELL = "sf50-clips-b32"
SEED = 2**31 + 23
SMALL = {"depths": [1, 1, 1, 1], "width_per_group": 16, "num_frames": 8, "crop_size": 32}


def small_clip_cell(monkeypatch):
    from realtime_analytics_tpu_torch.engine import temporal
    from realtime_analytics_tpu_torch.models.slowfast import SlowFastR50, SlowFastSpec

    cell = load_cell(CELL)
    cell.config.update(SMALL)
    cell.mix.update(batch=4, pool=16, width=32, height=32, warm_calls=1, check_batches=2)
    spec = SlowFastSpec(depths=tuple(SMALL["depths"]), width=SMALL["width_per_group"])
    monkeypatch.setattr(temporal, "build_temporal", lambda *a, **k: SlowFastR50(spec))
    return cell


@pytest.mark.parametrize("control", [False, True])
def test_small_run_decides_correct(monkeypatch, control):
    cell = small_clip_cell(monkeypatch)
    if control:
        cell.kind().control(cell.config)
    res = bench.run_cell(cell, SEED, 1.0, False, "cpu")
    assert res["correct"] is not control, res["checks"]
    assert sorted(res["checks"]) == ["clips", "logit_err", "logit_rms"]
    calls = res["attempted"] // 4  # the check keeps two calls of four clips
    assert res["checks"]["clips"]["value"] == 4 * min(calls, 2)
    assert res["failed"] == 0 and res["attempted"] % 4 == 0 and res["attempted"] > 0
    assert sorted(res["metrics"]) == ["footage_fps", "setup_s"]


def test_driver_readings(monkeypatch, tmp_path):
    cell = small_clip_cell(monkeypatch)
    ctx = bench.Context(cell, SEED, 1.0, False, "cpu", str(tmp_path))
    got = cell.driver().run(ctx)
    # a clip covers T x stride frames; calls that return after the close count no frames
    assert got["frames"] == got["clips"] * 8 * 2
    assert got["calls"] >= 1 and got["attempted"] == 4 * got["calls"] >= got["clips"]
    assert got["batch"] == 4
    assert got["clip_pack_ms"] is None and got["clip_step_ms"] is None  # no trace
    key, clip, logits = got["samples"][0]
    assert clip.shape == (8, 32, 32, 3) and clip.dtype.name == "uint8"
    assert logits.shape == (400,) and logits.dtype.name == "float32"
    # the ring closes on itself: the clip at ``key`` is frames key, key + 2, ...
    ring = cell.driver().footage(ctx, cell.mix)
    assert (clip == ring[[(key + 2 * i) % 16 for i in range(8)]]).all()


def test_check_readings_on_altered_logits(monkeypatch):
    cell = small_clip_cell(monkeypatch)
    kind = cell.kind()
    sd = seeded_state_dict(cell.config, 5)
    clips = torch.randint(0, 256, (3, 8, 32, 32, 3), generator=torch.Generator().manual_seed(5),
                          dtype=torch.uint8)
    ref = logits(SlowFast(cell.config, sd), clips)
    sound = [(i, clips[i].numpy(), ref[i].numpy()) for i in range(3)]
    checks = kind.check(cell.config, sd, sound, "cpu")
    assert checks["clips"]["value"] == 3 and checks["logit_err"]["value"] < 1e-3
    assert kind.passes(checks)
    shifted = ref.clone()
    shifted[1, 7] += 0.5 * ref[1].std()  # one logit of one clip off by half a std
    bad = [(i, clips[i].numpy(), shifted[i].numpy()) for i in range(3)]
    checks = kind.check(cell.config, sd, bad, "cpu")
    assert checks["logit_err"]["value"] == pytest.approx(50.0, rel=1e-3)
    assert checks["logit_rms"]["value"] == pytest.approx(50.0 / 20.0, rel=1e-3)
    assert not kind.passes(checks)
    assert not kind.passes(kind.check(cell.config, sd, [], "cpu"))  # no clip compared


def run_of(readings=None, trace=None, kind="NVIDIA H100 80GB HBM3", config=None):
    return SimpleNamespace(readings=readings or {}, trace=trace or {}, kind=kind,
                           window_s=30.0, config=config or load_cell(CELL).config)


@pytest.mark.parametrize("name", ["clip_pack_ms.clips", "clip_step_ms.clips", "mfu.clips",
                                  "epilogue_roofline.clips", "idle_share.clips"])
def test_readers_find_nothing_to_read(name):
    reader = load_cell(CELL).metric(name)
    assert reader.read(run_of()) is None
    # a run of another card, or whose trace has no B7 launch
    full = {"clips": 960, "batch": 32, "clip_pack_ms": None, "clip_step_ms": None}
    assert reader.read(run_of(full, kind="some other card")) is None
    assert reader.read(run_of(full, {"kernels": {"gemm": (0.5, 10)}, "busy_s": 0.0,
                                     "window_s": 0.0})) is None or name == "mfu.clips"


def test_readers_read():
    cell = load_cell(CELL)
    readings = {"clips": 960, "batch": 32, "clip_pack_ms": 21.5, "clip_step_ms": 30.25}
    per_step = len(clip_counts.epilogue_calls(cell.config))
    _, nbytes = clip_counts.epilogue_work(cell.config, 32, 2)
    trace = {"kernels": {"void conv_epilogue_kernel<bf16, 8, true, true>": (
        2 * 1.25 * nbytes / 3.35e12, 2 * per_step)}, "busy_s": 0.9, "window_s": 3.0}
    run = run_of(readings, trace)
    assert cell.metric("clip_pack_ms.clips").read(run) == 21.5
    assert cell.metric("clip_step_ms.clips").read(run) == 30.25
    assert cell.metric("epilogue_roofline.clips").read(run) == pytest.approx(80.0)
    assert cell.metric("idle_share.clips").read(run) == pytest.approx(70.0)
    mfu = 100 * cell.config["flops_per_clip"] * 960 / 30.0 / 989e12
    assert cell.metric("mfu.clips").read(run) == pytest.approx(mfu)


def test_epilogue_calls_are_the_programs_convs():
    """One B7 call a conv of the program's forward, with its output's size
    and whether it adds a shortcut: 110 calls, 21.72 GB a b32 step in bf16
    (6.48 ms at 3.35 TB/s)."""
    from realtime_analytics_tpu_torch.models.slowfast import FoldedConv3d, SlowFastR50

    config = load_cell(CELL).config
    with torch.device("meta"):
        model = SlowFastR50()
    seen = []
    for mod in model.modules():
        if isinstance(mod, FoldedConv3d):
            mod.register_forward_hook(
                lambda m, args, kwargs, out: seen.append(
                    (out.numel(), out.shape[1], kwargs.get("residual") is not None)),
                with_kwargs=True)
    with torch.no_grad():
        model(torch.empty(1, 32, 224, 224, 3, device="meta"))
    assert sorted(seen) == sorted(clip_counts.epilogue_calls(config))
    assert len(seen) == 110 and sum(r for *_, r in seen) == 32
    ops, nbytes = clip_counts.epilogue_work(config, 32, 2)
    assert nbytes / 1e9 == pytest.approx(21.72105, rel=1e-5)


def test_frozen_flops_per_clip():
    config = load_cell(CELL).config
    counted = flops_per_clip(config)
    assert config["flops_per_clip"] == counted
    assert counted / 2 * (256 / 224) ** 2 == pytest.approx(65.7e9, rel=0.01)  # PySlowFast's


def test_reference_layout_of_the_configuration():
    """The reference sizes the network from the configuration as
    PySlowFast does: 34,566,488 parameters with BN's gamma and beta
    (PyTorchVideo lists 34.57 M for slowfast_r50), 662 keys."""
    config = load_cell(CELL).config
    shapes = manifest(config)
    assert len(shapes) == 662
    assert sum(math.prod(s) for k, s in shapes.items()
               if not k.endswith(("running_mean", "running_var", "num_batches_tracked"))) \
        == 34_566_488
    assert shapes["s1.pathway0_stem.conv.weight"] == (64, 3, 1, 7, 7)
    assert shapes["s1.pathway1_stem.conv.weight"] == (8, 3, 5, 7, 7)
    assert shapes["s1_fuse.conv_f2s.weight"] == (16, 8, 7, 1, 1)
    assert shapes["s2.pathway0_res0.branch1.weight"] == (256, 80, 1, 1, 1)
    assert shapes["s3.pathway0_res0.branch2.a.weight"] == (128, 320, 1, 1, 1)
    assert shapes["s4.pathway0_res0.branch2.a.weight"] == (256, 640, 3, 1, 1)
    assert shapes["s4.pathway1_res5.branch2.a.weight"] == (32, 128, 3, 1, 1)
    assert shapes["s5.pathway0_res0.branch2.b.weight"] == (512, 512, 1, 3, 3)
    assert shapes["s5.pathway1_res2.branch2.c.weight"] == (256, 64, 1, 1, 1)
    assert shapes["head.projection.weight"] == (400, 2304)
    assert "s2.pathway0_res1.branch1.weight" not in shapes  # no projection past a stage's first


@pytest.mark.parametrize("key,shape", [("s1_fuse.conv_f2s.weight", (4, 2, 5, 1, 1)),
                                       ("s2.pathway1_res0.branch2.a.weight", (2, 2, 1, 1, 1))])
def test_reference_refuses_a_state_of_other_shapes(key, shape):
    """A state whose lateral kernel or temporal kernel is not the
    configuration's does not load."""
    config = {**load_cell(CELL).config, **SMALL}
    sd = seeded_state_dict(config, 3)
    SlowFast(config, sd)
    with pytest.raises(RuntimeError, match="size mismatch"):
        SlowFast(config, {**sd, key: torch.zeros(shape)})
    missing = {k: v for k, v in sd.items() if k != key}
    with pytest.raises(RuntimeError, match="Missing key"):
        SlowFast(config, missing)


def test_seeded_state_is_the_seeds():
    config = {**load_cell(CELL).config, **SMALL}
    a, b = seeded_state_dict(config, 7), seeded_state_dict(config, 7)
    assert list(a) == list(manifest(config))
    assert all(torch.equal(a[k], b[k]) for k in a)
    c = seeded_state_dict(config, 8)
    assert not torch.equal(a["head.projection.weight"], c["head.projection.weight"])
    gammas = [v for k, v in a.items() if k.endswith("c_bn.weight")]
    assert all(0.2 <= float(g.min()) and float(g.max()) <= 0.4 for g in gammas)  # none zero


def test_reference_leaves_tf32_as_it_found_it():
    config = {**load_cell(CELL).config, **SMALL}
    model = SlowFast(config, seeded_state_dict(config, 3))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        logits(model, torch.zeros(1, 8, 32, 32, 3, dtype=torch.uint8))
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_the_cell_is_in_the_spec():
    spec = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "slowfast-r50-8x8-224-bf16"
    fps = next(m for m in spec["end_to_end"] if m["name"] == "footage_fps")
    assert CELL in fps["workloads"]
