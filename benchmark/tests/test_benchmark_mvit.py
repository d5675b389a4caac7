"""The MViT cell (``mvit2s-clips-b32``): MViTv2's model kind, its plain
reference, its seeded weights, B8's counts and the cell's readers, on the
CPU at a small size (embed 16, depth 4 with the width, the heads and the q
stride doubling at blocks 1 and 3, 4 frames at stride 4 of 64 x 64, 4 clips
a call): the program builds that spec in place of the published one."""

from __future__ import annotations

import json
import math
from types import SimpleNamespace

import pytest
import torch

from benchmark import mvit_counts, run as bench
from benchmark.cells import ROOT, load_cell
from benchmark.mvit_weights import LN_GAMMA, seeded_state_dict
from benchmark.reference.mvit import MViT, logits, manifest

CELL = "mvit2s-clips-b32"
SEED = 2**31 + 29
SMALL = {"depth": 4, "embed_dim": 16, "num_frames": 4, "crop_size": 64,
         "dim_mul": [[1, 2.0], [3, 2.0]], "head_mul": [[1, 2.0], [3, 2.0]],
         "pool_q_stride": [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1], [3, 1, 2, 2]]}


def small_config():
    return {**load_cell(CELL).config, **SMALL}


def small_mvit_cell(monkeypatch):
    from realtime_analytics_tpu_torch.engine import temporal
    from realtime_analytics_tpu_torch.models.mvit import MViT as Program, MViTSpec

    cell = load_cell(CELL)
    cell.config.update(SMALL)
    cell.mix.update(batch=4, pool=16, width=64, height=64, warm_calls=1, check_batches=2)
    spec = MViTSpec(depth=4, embed_dim=16, stages=(1, 3), num_frames=4, crop=64)
    monkeypatch.setattr(temporal, "build_temporal", lambda *a, **k: Program(spec))
    return cell


def test_the_cell_loads_through_load_cell():
    cell = load_cell(CELL)
    assert cell.config["name"] == "mvitv2-s-16x4-224-bf16" and cell.config["kind"] == "mvit"
    assert cell.mix["driver"] == "clips" and cell.mix["batch"] == 32
    assert cell.end_to_end == ["setup_s", "footage_fps"]
    assert cell.per_layer == ["clip_pack_ms.mvit", "clip_step_ms.mvit", "mfu.mvit",
                              "attention_roofline.mvit", "idle_share.mvit"]
    assert cell.kind().CONTROL_DTYPE == "float8_e4m3fn"
    for name in cell.end_to_end + cell.per_layer:
        assert cell.metric(name).UNIT


def test_the_cell_is_in_the_spec():
    spec = json.loads((ROOT.parent / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "mvitv2-s-16x4-224-bf16"
    assert cell["traffic"] == "clips-224-b32"
    fps = next(m for m in spec["end_to_end"] if m["name"] == "footage_fps")
    assert fps["workloads"] == ["v8l-footage-b32", "sf50-clips-b32", CELL]
    config = next(c for c in spec["configs"] if c["name"] == "mvitv2-s-16x4-224-bf16")
    assert config["reduced"] == [] and config["file"].endswith("mvitv2-s-16x4-224-bf16.json")
    ours = [m for m in spec["per_layer"] if m["name"].endswith(".mvit")]
    assert sorted(m["name"] for m in ours) == sorted(load_cell(CELL).per_layer)
    assert all(m["workloads"] == [CELL] and m["moves"] == "footage_fps" for m in ours)


@pytest.mark.parametrize("control", [False, True])
def test_small_run_decides_correct(monkeypatch, control):
    cell = small_mvit_cell(monkeypatch)
    if control:
        cell.kind().control(cell.config)
    res = bench.run_cell(cell, SEED, 1.0, False, "cpu")
    assert res["correct"] is not control, res["checks"]
    assert sorted(res["checks"]) == ["clips", "logit_err", "logit_rms"]
    assert res["failed"] == 0 and res["attempted"] % 4 == 0 and res["attempted"] > 0
    assert sorted(res["metrics"]) == ["footage_fps", "setup_s"]


def test_driver_readings(monkeypatch, tmp_path):
    cell = small_mvit_cell(monkeypatch)
    ctx = bench.Context(cell, SEED, 1.0, False, "cpu", str(tmp_path))
    got = cell.driver().run(ctx)
    # a clip covers T x stride frames: 4 x 4 here, 16 x 4 = 64 at the cell's size
    assert got["frames"] == got["clips"] * 4 * 4
    key, clip, served = got["samples"][0]
    assert clip.shape == (4, 64, 64, 3) and served.shape == (400,)
    ring = cell.driver().footage(ctx, cell.mix)
    assert (clip == ring[[(key + 4 * i) % 16 for i in range(4)]]).all()


def test_reference_loads_strictly():
    config = small_config()
    sd = seeded_state_dict(config, 3)
    MViT(config, sd)
    with pytest.raises(RuntimeError, match="Missing key"):
        MViT(config, {k: v for k, v in sd.items() if k != "blocks.1.attn.rel_pos_h"})
    with pytest.raises(RuntimeError, match="Unexpected key"):
        MViT(config, {**sd, "blocks.0.attn.pos_embed": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="size mismatch"):
        MViT(config, {**sd, "blocks.0.attn.rel_pos_t": torch.zeros(9, 16)})


def test_seeded_state_layout():
    config = small_config()
    a, b = seeded_state_dict(config, 7), seeded_state_dict(config, 7)
    assert list(a) == list(manifest(config))
    assert all(tuple(v.shape) == s and v.dtype == torch.float32
               for v, s in zip(a.values(), manifest(config).values()))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["cls_token"], seeded_state_dict(config, 8)["cls_token"])
    norms = [v for k, v in a.items() if k.endswith(".weight") and v.dim() == 1]
    assert norms and all(LN_GAMMA[0] <= float(v.min()) and float(v.max()) <= LN_GAMMA[1]
                         for v in norms)
    rel = a["blocks.0.attn.rel_pos_h"]  # of the order 1 / sqrt(head dim)
    assert 0.5 < float(rel.std()) * math.sqrt(rel.shape[1]) < 1.5


def test_published_layout():
    shapes = manifest(load_cell(CELL).config)
    assert sum(math.prod(s) for s in shapes.values()) == 34_537_744
    assert shapes["patch_embed.proj.weight"] == (96, 3, 3, 7, 7)
    assert shapes["blocks.0.attn.rel_pos_h"] == (111, 96)
    assert shapes["blocks.1.attn.qkv.weight"] == (576, 96)
    assert shapes["blocks.1.proj.weight"] == (192, 96)
    assert shapes["blocks.15.attn.rel_pos_w"] == (13, 96)
    assert shapes["blocks.15.attn.rel_pos_t"] == (15, 96)
    assert shapes["head.projection.weight"] == (400, 768)


def test_reference_leaves_tf32_as_it_found_it():
    config = small_config()
    model = MViT(config, seeded_state_dict(config, 3))
    seen = []
    model.blocks[0].register_forward_hook(lambda *a: seen.append(
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)))
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        logits(model, torch.zeros(1, 4, 64, 64, 3, dtype=torch.uint8))
        assert seen == [(False, False)]
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_counts_of_block_0_by_hand():
    """Block 0 of MViTv2-S: one head of 96 over 25,089 query and 393 key
    tokens; its tables k_t + k_h + k_w = 8 + 7 + 7 wide."""
    config = load_cell(CELL).config
    calls = mvit_counts.attention_calls(config)
    assert len(calls) == 16 and calls[0] == (1, 96, 25089, 393, 22)
    assert calls[1] == (2, 96, 6273, 1569, 36)
    flops, nbytes = mvit_counts.call_work(*calls[0], 32, 2)
    assert flops == 4 * 32 * 25089 * 393 * 96
    assert nbytes == 32 * (2 * (25089 + 393) * 96 + 25088 * 22) * 2
    total, _ = mvit_counts.attention_work(config, 1, 2)
    assert total / 1e9 == pytest.approx(28.857, rel=1e-3)  # QK^T and PV, 22% of the model


def run_of(readings=None, trace=None, kind="NVIDIA H100 80GB HBM3"):
    return SimpleNamespace(readings=readings or {}, trace=trace or {}, kind=kind,
                           window_s=30.0, config=load_cell(CELL).config)


@pytest.mark.parametrize("name", ["clip_pack_ms.mvit", "clip_step_ms.mvit", "mfu.mvit",
                                  "attention_roofline.mvit", "idle_share.mvit"])
def test_readers_find_nothing_to_read(name):
    reader = load_cell(CELL).metric(name)
    assert reader.read(run_of()) is None
    full = {"clips": 640, "batch": 32, "clip_pack_ms": None, "clip_step_ms": None}
    assert reader.read(run_of(full, kind="some other card")) is None


def test_attention_roofline_needs_a_steps_launches():
    flops, nbytes = mvit_counts.attention_work(load_cell(CELL).config, 32, 2)
    least = max(flops / 989e12, nbytes / 3.35e12)
    name = "void (anonymous namespace)::rel_pos_attention_kernel(const __nv_bfloat16 *)"
    reader = load_cell(CELL).metric("attention_roofline.mvit")
    readings = {"clips": 640, "batch": 32}
    assert reader.read(run_of(readings, {"kernels": {name: (4 * least, 15)}})) is None
    assert reader.read(run_of(readings, {"kernels": {name: (2 * 4 * least, 32)}})) \
        == pytest.approx(25.0)
    # a parent without the kernel: nothing to read, nothing raised
    assert reader.read(run_of(readings, {"kernels": {"gemm": (1.0, 100)}})) is None


def test_readers_read():
    cell = load_cell(CELL)
    readings = {"clips": 640, "batch": 32, "clip_pack_ms": 11.5, "clip_step_ms": 40.25}
    run = run_of(readings, {"kernels": {}, "busy_s": 2.7, "window_s": 3.0})
    assert cell.metric("clip_pack_ms.mvit").read(run) == 11.5
    assert cell.metric("clip_step_ms.mvit").read(run) == 40.25
    assert cell.metric("idle_share.mvit").read(run) == pytest.approx(10.0)
    mfu = 100 * cell.config["flops_per_clip"] * 640 / 30.0 / 989e12
    assert cell.metric("mfu.mvit").read(run) == pytest.approx(mfu)
