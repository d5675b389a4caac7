"""SlowFast R50 8x8 (``model_type: slowfast_r50``) against its plain fp32
reference, on the CPU.

The reference (``tests/plain_slowfast.py``, a byte-for-byte copy of the
benchmark's ``benchmark/reference/slowfast.py``) reads the same PySlowFast
``model_state`` and keeps every BatchNorm as a separate eval-mode op, so the
port's BN folding is held too. The program runs a small spec (depths
[1, 1, 1, 1], slow width 16, T 8 at 32 x 32; the engine tests T 32 at
stride 2) built by the same code as the published one.

Tolerances, as ``logit_err``: the largest |program - reference| over a
clip's logits over the standard deviation of that clip's reference logits,
in %, the benchmark check's measure.

* fp32: 0.01% (1e-4 relative): the two sum the same products in another
  order and the port folds BN into the conv weights in fp32 (readings
  about 0.0002%).
* bf16: 6%: every conv's operands and output, and every shortcut, are
  rounded to bf16 (2^-9 relative a rounding, a dozen roundings deep at this
  spec, random signs); readings 2.0-2.2% on three seeds.
* Controls, which must exceed the bf16 tolerance: the weights rounded
  through ``float8_e4m3fn`` (the next precision below bf16; readings
  19-24%), and the program with its four laterals zeroed (the slow pathway
  without the fast one's; readings over 100%).

The stems' stacked route (each a 2D conv over stacked frames, its weight
with zero columns) runs only on the card; here its parts are called
directly in fp32 and held to conv3d within 1e-6 of the output's scale, and
the CPU forward takes the route nowhere.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_slowfast as plain  # noqa: E402

from realtime_analytics_tpu_torch.config import (  # noqa: E402
    ConfigError,
    DetectorConfig,
    StreamConfig,
)
from realtime_analytics_tpu_torch.engine import temporal as temporal_engine  # noqa: E402
from realtime_analytics_tpu_torch.engine.detector import create_detector  # noqa: E402
from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine  # noqa: E402
from realtime_analytics_tpu_torch.models import weights  # noqa: E402
from realtime_analytics_tpu_torch.models.slowfast import (  # noqa: E402
    FoldedConv3d,
    SlowFastR50,
    SlowFastSpec,
    conv_names,
    slow_indices,
    stack_frames,
    stacked_convs,
    unstack_frames,
)
from realtime_analytics_tpu_torch.models.temporal import build_temporal  # noqa: E402
from realtime_analytics_tpu_torch.telemetry import spans  # noqa: E402
from realtime_analytics_tpu_torch.types import FramePacket  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = SlowFastSpec(depths=(1, 1, 1, 1), width=16)
# the reference's configurations (the benchmark configuration's keys)
PUBLISHED = {"alpha": 4, "beta_inv": 8, "fusion_conv_channel_ratio": 2, "fusion_kernel_size": 7,
             "depths": [3, 4, 6, 3], "width_per_group": 64, "num_classes": 400,
             "num_frames": 32, "crop_size": 224}
SMALL_REF = {**PUBLISHED, "depths": [1, 1, 1, 1], "width_per_group": 16}
FP32_TOL, BF16_TOL = 0.01, 6.0  # logit_err, %


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


def logit_err(got, want) -> float:
    """The largest |got - want| of a clip over its reference logits' std, in %."""
    got, want = torch.as_tensor(got, dtype=torch.float32), torch.as_tensor(want)
    return float(((got - want).abs().amax(1) / want.std(1)).max()) * 100


def clips_u8(seed, n=3, t=8, hw=32):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, t, hw, hw, 3), generator=g, dtype=torch.uint8)


def normalised(clips):
    """The engine's input to the model: RGB, [0, 1], mean/std 0.45/0.225."""
    return (clips.to(torch.float32).flip(-1) * (1.0 / 255.0) - 0.45) / 0.225


def program(sd, spec=SMALL, dtype=torch.float32):
    model = SlowFastR50(spec).eval()
    weights.temporal_params_from_jax(model, weights.slowfast_params_from_state_dict(model, sd))
    return model.to(dtype)


def run(model, clips, dtype=torch.float32):
    with torch.no_grad():
        return model(normalised(clips).to(dtype)).float()


@pytest.fixture(scope="module")
def seeded():
    sd = weights.slowfast_seeded_state_dict(SMALL, seed=11)
    clips = clips_u8(11)
    return sd, clips, plain.logits(plain.SlowFast(SMALL_REF, sd), clips)


def test_fp32_program_matches_the_reference(seeded):
    sd, clips, want = seeded
    assert logit_err(run(program(sd), clips), want) < FP32_TOL


def test_bf16_program_within_its_tolerance(seeded):
    sd, clips, want = seeded
    got = run(program(sd, dtype=torch.bfloat16), clips, torch.bfloat16)
    assert logit_err(got, want) < BF16_TOL


@pytest.mark.parametrize("control", ["float8_e4m3fn", "no_laterals"])
def test_controls_fail_the_comparison(seeded, control):
    sd, clips, want = seeded
    if control == "float8_e4m3fn":
        sd = {k: v.to(torch.float8_e4m3fn).float() if v.dim() >= 2 else v for k, v in sd.items()}
    model = program(sd, dtype=torch.bfloat16)
    if control == "no_laterals":
        for name, mod in model.named_modules():
            if name.endswith("conv_f2s"):
                mod.weight.data.zero_()
                mod.bias.data.zero_()
    assert logit_err(run(model, clips, torch.bfloat16), want) > BF16_TOL


@pytest.mark.parametrize("conv", ["s1.pathway1_stem.conv", "s1_fuse.conv_f2s",
                                  "s3.pathway0_res0.branch1", "s4.pathway1_res0.branch2.a",
                                  "s5.pathway0_res0.branch2.c"])
def test_bn_folding_equals_bn_in_eval_mode(seeded, conv):
    sd = seeded[0]
    model = program(sd)
    folded = dict(model.named_modules())[conv]
    w = sd[f"{conv}.weight"]
    bn = torch.nn.BatchNorm3d(w.shape[0], eps=1e-5).eval()
    prefix = weights.slowfast_bn_name(conv)
    bn.load_state_dict({k: sd[f"{prefix}.{k}"] for k in (
        "weight", "bias", "running_mean", "running_var", "num_batches_tracked")})
    x = torch.randn(2, w.shape[1], 5, 6, 6, generator=torch.Generator().manual_seed(3))
    want = bn(torch.nn.functional.conv3d(x, w, None, folded.stride, folded.padding))
    with torch.no_grad():
        got = folded(x, relu=False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("stem,frames", [("pathway0_stem", 8), ("pathway1_stem", 8),
                                         ("pathway0_stem", 4), ("pathway1_stem", 4)])
def test_stacked_stem_equals_the_3d_conv(seeded, stem, frames, group):
    """A stem's conv as the 2D conv over stacked frames (its input
    ``stack_frames``, its weight ``stacked_weight``: ``group`` output frames
    a row) equals cuDNN's route, conv3d, in fp32 within 1e-6 of the output's
    scale, on a stem-shaped and a 4-frame input; the weight keeps its
    published shape."""
    conv = getattr(program(seeded[0]).s1, stem).conv
    kt = conv.weight.shape[2]
    gen = torch.Generator().manual_seed(frames)
    x = torch.randn(2, 3, frames, 32, 32, generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    with torch.no_grad():
        want = torch.nn.functional.conv3d(x, conv.weight, None, conv.stride, conv.padding)
        rows = stack_frames(x, kt, group)
        assert rows.shape == (2 * frames // group, 3 * (kt + group - 1), 32, 32)
        assert rows.is_contiguous(memory_format=torch.channels_last)
        y = torch.nn.functional.conv2d(rows, conv.stacked_weight(group), None,
                                       conv.stride[1:], conv.padding[1:])
        got = unstack_frames(y, 2, group)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * want.abs().max().item())
    assert conv.weight.shape[1] == 3
    assert conv.stacked_weight(group).shape == (group * conv.weight.shape[0],
                                                3 * (kt + group - 1), 7, 7)


def test_stacked_weight_has_zero_columns_and_follows_the_weight(seeded):
    """Output frame f's rows hold tap k at frame f + k and zeros elsewhere;
    the 2D weight is made once, and again when the weight changes (in place
    or replaced)."""
    conv = program(seeded[0]).s1.pathway1_stem.conv
    cout = conv.weight.shape[0]
    first = conv.stacked_weight(4)
    assert conv.stacked_weight(4) is first
    blocks = first.view(4, cout, 8, 3, 7, 7)
    for f in range(4):
        for j in range(8):
            want = conv.weight[:, :, j - f] if 0 <= j - f < 5 else torch.zeros(cout, 3, 7, 7)
            assert torch.equal(blocks[f, :, j], want)
    with torch.no_grad():
        conv.weight.mul_(2)
    second = conv.stacked_weight(4)
    assert second is not first and torch.equal(second.view(4, cout, 8, 3, 7, 7)[0, :, 0],
                                                conv.weight[:, :, 0])
    conv.weight.data = conv.weight.data.double()
    assert conv.stacked_weight(4).dtype == torch.float64
    with torch.inference_mode():  # a model made there: its weight keeps no version
        made = FoldedConv3d(3, 8, (5, 7, 7), (1, 2, 2))
        assert made.stacked_weight(4) is made.stacked_weight(4)


def test_cpu_forward_stacks_nothing_and_keeps_the_state(seeded):
    """On the CPU neither fp32 nor bf16 nor fp16 takes the stacked route:
    the convs count 0; and after the stacked weights were made, the state
    dict and the params tree are those of the published layout, byte for
    byte."""
    sd, clips, _ = seeded
    model = program(sd)
    stems = (model.s1.pathway0_stem.conv, model.s1.pathway1_stem.conv)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    trees = [c.to_tree() for c in stems]
    x = normalised(clips).permute(0, 4, 1, 2, 3)
    with torch.no_grad():
        assert [stems[1].stack_group(x.to(d)) for d in
                (torch.float32, torch.bfloat16, torch.float16)] == [0, 0, 0]
    run(model, clips)
    run(program(sd, dtype=torch.bfloat16), clips, torch.bfloat16)
    assert stacked_convs(model) == 0
    for conv, group in zip(stems, (1, 4)):
        conv.stacked_weight(group)
    assert list(model.state_dict()) == list(state)
    assert all(torch.equal(v, state[k]) for k, v in model.state_dict().items())
    for conv, tree in zip(stems, trees):
        new = conv.to_tree()
        assert all(np.array_equal(new[k], tree[k]) for k in tree)
    assert trees[1]["w"].shape == (5, 7, 7, 3, 2)


def test_the_ports_layout_is_the_references():
    """The port's PySlowFast layout at the small spec is the one the
    reference sizes from its configuration, key for key, and the reference
    refuses a state of another lateral kernel."""
    assert list(weights.slowfast_manifest(SMALL).items()) == list(plain.manifest(SMALL_REF).items())
    other = SlowFastSpec(depths=(1, 1, 1, 1), width=16, fusion_kernel=5)
    with pytest.raises(RuntimeError, match="size mismatch"):
        plain.SlowFast(SMALL_REF, weights.slowfast_seeded_state_dict(other, seed=1))


def test_slow_pathway_takes_the_linspace_frames():
    assert slow_indices(32, 4) == [0, 4, 8, 13, 17, 22, 26, 31]  # not ::4
    assert slow_indices(8, 4) == [0, 7]
    model = SlowFastR50(SMALL)
    x = torch.arange(32.0).view(1, 1, 32, 1, 1).expand(2, 3, 32, 4, 4)
    picked = model.slow_frames(x)[0, 0, :, 0, 0]
    assert picked.tolist() == [0.0, 4.0, 8.0, 13.0, 17.0, 22.0, 26.0, 31.0]


def test_published_spec_parameter_count():
    """34,536,144 parameters once BN is folded; with BN's gamma and beta
    beside each conv, 34,566,488: PyTorchVideo's 34.57 M for slowfast_r50."""
    with torch.device("meta"):
        model = build_temporal("slowfast_r50", 400)
    convs = [m for m in model.modules() if isinstance(m, FoldedConv3d)]
    folded = sum(p.numel() for p in model.parameters())
    assert folded == 34_536_144
    assert folded + sum(c.weight.shape[0] for c in convs) == 34_566_488
    assert len(convs) == 110  # 2 stems, 4 laterals, 2 x 16 bottlenecks x 3, 8 projections
    manifest = weights.slowfast_manifest()
    assert list(manifest.items()) == list(plain.manifest(PUBLISHED).items())
    assert manifest["s1.pathway0_stem.conv.weight"] == (64, 3, 1, 7, 7)
    assert manifest["s1.pathway1_stem.conv.weight"] == (8, 3, 5, 7, 7)
    assert manifest["s1_fuse.conv_f2s.weight"] == (16, 8, 7, 1, 1)
    assert manifest["s2.pathway0_res0.branch1.weight"] == (256, 80, 1, 1, 1)
    assert manifest["s4.pathway0_res0.branch2.a.weight"] == (256, 640, 3, 1, 1)
    assert manifest["s3.pathway0_res0.branch2.a.weight"] == (128, 320, 1, 1, 1)
    assert manifest["s5.pathway1_res2.branch2.c.weight"] == (256, 64, 1, 1, 1)
    assert manifest["head.projection.weight"] == (400, 2304)
    assert conv_names(model)[:3] == ["s1.pathway0_stem.conv", "s1.pathway1_stem.conv",
                                     "s1_fuse.conv_f2s"]


def test_flops_per_clip_of_the_published_spec():
    """About 50.3 G multiply-adds a 32 x 224 x 224 clip (PySlowFast lists
    65.7 G at its 256 test crop: (256 / 224)^2 x 50.3 = 65.7)."""
    flops = plain.flops_per_clip(PUBLISHED)
    assert flops == pytest.approx(1.00617e11, rel=1e-4)
    assert flops * (256 / 224) ** 2 / 2 == pytest.approx(65.7e9, rel=0.01)


def test_reference_copies_are_byte_identical():
    with open(os.path.join(REPO, "tests", "plain_slowfast.py"), "rb") as a, \
            open(os.path.join(REPO, "benchmark", "reference", "slowfast.py"), "rb") as b:
        assert a.read() == b.read()


def test_seeded_weights_keep_every_branch_live_and_bounded():
    """At the published depth (slow width 16): each block's activations stay
    within a few units, and every residual branch adds between a twentieth
    and the whole of its shortcut's scale."""
    spec = SlowFastSpec(width=16)
    sd = weights.slowfast_seeded_state_dict(spec, seed=5)
    ref = plain.SlowFast({**PUBLISHED, "width_per_group": 16}, sd)
    seen = []

    def hook(mod, inp, out):
        x = inp[0]
        sc = mod.branch1_bn(mod.branch1(x)) if mod.has_branch1 else x
        seen.append((out.pow(2).mean().sqrt().item(),
                     (mod.branch2(x).pow(2).mean() / sc.pow(2).mean()).sqrt().item()))

    for m in ref.modules():
        if isinstance(m, plain.Block):
            m.register_forward_hook(hook)
    lg = plain.logits(ref, clips_u8(5, n=2, t=32, hw=64))
    assert len(seen) == 32
    assert all(0.5 < rms < 8.0 and 0.05 < ratio < 1.0 for rms, ratio in seen)
    probs = torch.softmax(lg, dim=1)
    assert float(probs.amax()) < 0.6 and float(lg.std(1).min()) > 1.0


def test_config_refuses_a_clip_not_a_multiple_of_alpha():
    DetectorConfig(model_type="slowfast_r50", sequence_length=32).validate()
    with pytest.raises(ConfigError, match="multiple of"):
        DetectorConfig(model_type="slowfast_r50", sequence_length=30).validate()
    with pytest.raises(ConfigError, match="mesh_shape"):
        DetectorConfig(model_type="slowfast_r50", mesh_shape=[2, 1]).validate()
    cfg = DetectorConfig(model_type="slowfast_r50")
    assert cfg.resolved_input_size == (224, 224)


# -- the engine ------------------------------------------------------------------


@pytest.fixture
def small_engine(monkeypatch, tmp_path):
    """A ``slowfast_r50`` engine on the CPU at the small spec, T 32 at stride
    2, 32 x 32 frames, from a PySlowFast checkpoint file."""
    monkeypatch.setattr(temporal_engine, "build_temporal",
                        lambda *a, **k: SlowFastR50(SMALL))
    sd = weights.slowfast_seeded_state_dict(SMALL, seed=21)
    path = str(tmp_path / "slowfast_r50.pyth")
    torch.save({"model_state": sd, "epoch": 196}, path)
    cfg = DetectorConfig(model_path=path, model_type="slowfast_r50", device="cpu",
                         precision="fp32", input_size=[32, 32], sequence_length=32,
                         sequence_stride=2, temporal_overlap=0.0, batch_buckets=[2],
                         max_batch_size=2, confidence_threshold=1e-6, warmup=False)
    eng = create_detector(cfg)
    assert isinstance(eng, TorchTemporalEngine) and isinstance(eng.model, SlowFastR50)
    return eng, plain.SlowFast(SMALL_REF, sd)


def window(seed, n=64, hw=32):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, hw, hw, 3), generator=g, dtype=torch.uint8).numpy()


def test_predict_packets_buffers_a_64_frame_window(small_engine):
    eng, ref = small_engine
    frames = window(1)
    stream = StreamConfig(name="cam-0")
    packets = [FramePacket(stream, f, i, float(i)) for i, f in enumerate(frames)]
    for p in packets[:63]:
        assert eng.predict_packets([p]) == [[]]
    dets = eng.predict_packets([packets[63]])[0]
    clip = torch.from_numpy(frames[::2][None])  # frames 0, 2, ..., 62
    want = plain.logits(ref, clip)
    probs, classes = torch.topk(torch.softmax(want, 1), 5)
    assert [d.class_id for d in dets] == classes[0].tolist()
    np.testing.assert_allclose([d.confidence for d in dets], probs[0].numpy(), rtol=1e-4)
    assert (dets[0].sequence_start_frame, dets[0].sequence_end_frame) == (0, 62)
    # the same clip through predict_clips: the step's logits come back
    seq = [packets[i] for i in range(0, 64, 2)]
    got_dets, logits = eng.predict_clips([seq], return_logits=True)
    assert logits.shape == (1, 400) and logits.dtype == np.float32
    assert logit_err(logits, want) < FP32_TOL
    assert [d.class_id for d in got_dets[0]] == [d.class_id for d in dets]


def test_spans_under_a_profiler_and_counters(small_engine):
    eng, _ = small_engine
    frames = window(2)
    stream = StreamConfig(name="cam-1")
    seqs = [[FramePacket(stream, frames[(o + 2 * i) % 64], i, 0.0) for i in range(32)]
            for o in (0, 5, 9)]
    before = (eng.stats.calls, eng.stats.clips, eng.stats.frames_packed,
              eng.stats.bytes_uploaded)
    kept = len(spans.LOG.spans())
    eng.predict_clips(seqs[:1])  # no profiler: no span kept
    assert len(spans.LOG.spans()) == kept
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        eng.predict_clips(seqs)  # 3 clips: bucket 2 is the largest, so they run unpadded
        names = [s.name for s in spans.LOG.spans()]
    assert names.count("clip_pack") == 1 and names.count("clip_step") == 1
    assert names.count("batch") == 1
    step = spans.LOG.spans("clip_step")[0]
    batch = spans.LOG.spans("batch")[0]
    assert batch.start_ns <= step.start_ns <= step.end_ns <= batch.end_ns
    assert step.batch == batch.batch is not None
    eng.predict_clips(seqs[:2])  # the session over: nothing added
    assert len(spans.LOG.spans()) == len(names)
    clip_bytes = 32 * 32 * 32 * 3
    assert (eng.stats.calls - before[0], eng.stats.clips - before[1],
            eng.stats.frames_packed - before[2], eng.stats.bytes_uploaded - before[3]) == (
        3, 6, 6 * 32, (2 + 3 + 2) * clip_bytes)


def test_cpu_engine_counts_no_stacked_conv(small_engine):
    eng, _ = small_engine
    frames = window(5)
    stream = StreamConfig(name="cam-4")
    eng.predict_clips([[FramePacket(stream, frames[2 * i], i, 0.0) for i in range(32)]])
    assert eng.stats.calls >= 1 and eng.stats.stacked_convs == 0


def test_seeded_engine_without_a_checkpoint(monkeypatch):
    """No checkpoint: the engine serves ``slowfast_seeded_state_dict``'s seed
    0, folded (``temporal_synthetic_params``)."""
    monkeypatch.setattr(temporal_engine, "build_temporal", lambda *a, **k: SlowFastR50(SMALL))
    cfg = DetectorConfig(model_path="missing-slowfast.pyth", model_type="slowfast_r50",
                         device="cpu", precision="fp32", input_size=[32, 32],
                         sequence_length=8, batch_buckets=[1], max_batch_size=1, warmup=False)
    eng = TorchTemporalEngine(cfg)
    want = program(weights.slowfast_seeded_state_dict(SMALL, seed=0))
    for a, b in zip(eng.model.parameters(), want.parameters()):
        assert torch.equal(a, b)


def test_concurrent_calls_keep_their_own_clips_and_counts(small_engine):
    """The batcher calls ``predict_clips`` from several threads: each packs
    into its own staging buffer, so every call serves its own clips, and the
    counters lose no update."""
    import threading

    eng, _ = small_engine
    frames = window(3)
    stream = StreamConfig(name="cam-2")
    seqs = [[FramePacket(stream, frames[(o + 2 * i) % 64], i, 0.0) for i in range(32)]
            for o in range(8)]
    want = [eng.predict_clips([s], return_logits=True)[1][0] for s in seqs]
    before = (eng.stats.calls, eng.stats.clips)
    got, errors = {}, []

    def worker(k):
        try:
            for r in range(3):
                o = (k + r) % 8
                got[(k, r)] = (o, eng.predict_clips([seqs[o]], return_logits=True)[1][0])
        except Exception as exc:  # noqa: BLE001 - reported below
            errors.append(exc)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(k,)) for k in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(saved)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(got) == 18
    for o, logits in got.values():  # another clip's logits differ by whole units
        np.testing.assert_allclose(logits, want[o], rtol=1e-4, atol=1e-4)
    assert (eng.stats.calls - before[0], eng.stats.clips - before[1]) == (18, 18)


def test_staging_reuses_buffers_of_one_frame_shape():
    """A call takes the smallest free buffer with room for its clips; where
    none has room, or the frame shape differs, the free ones are released
    and a new one made; two calls at once hold two buffers."""
    staging = temporal_engine.ClipStaging(pin=False)
    frame = (8, 32, 32, 3)
    a = staging.take(4, frame)
    b = staging.take(2, frame)  # a is held: a second buffer
    assert a.shape == (4, *frame) and b.shape == (2, *frame) and a.data_ptr() != b.data_ptr()
    staging.give(a)
    staging.give(b)
    assert staging.take(2, frame) is b and staging.take(3, frame) is a
    staging.give(a)
    staging.give(b)
    c = staging.take(6, frame)  # none has room: a and b released
    assert c.shape == (6, *frame) and staging._free == []
    staging.give(c)
    assert staging.take(1, frame) is c
    d = staging.take(2, (8, 16, 16, 3))  # another frame shape
    staging.give(c)  # a buffer of the released shape is not kept
    staging.give(d)
    assert staging._free == [d]
    assert staging.pinned_bytes == 0


@pytest.mark.cuda
def test_staging_is_pinned_on_the_card(monkeypatch):
    """On the card the pack's staging buffers are pinned (the upload is one
    DMA), up to ``PIN_BYTES`` an engine, and reused while the frame shape
    holds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100 machine)")
    monkeypatch.setattr(temporal_engine, "build_temporal", lambda *a, **k: SlowFastR50(SMALL))
    cfg = DetectorConfig(model_path="missing-slowfast.pyth", model_type="slowfast_r50",
                         device="cuda", input_size=[32, 32], sequence_length=8,
                         batch_buckets=[2], max_batch_size=2, warmup=False)
    eng = TorchTemporalEngine(cfg)
    frames = window(4)
    stream = StreamConfig(name="cam-3")
    seqs = [[FramePacket(stream, frames[(o + i) % 64], i, 0.0) for i in range(8)] for o in (0, 3)]
    _, got = eng.predict_clips(seqs, return_logits=True)
    assert np.isfinite(got).all() and got.shape == (2, 400)
    buf = eng._staging.take(2, (8, 32, 32, 3))
    assert buf.is_pinned() and eng._staging.pinned_bytes == buf.numel()
    staging = temporal_engine.ClipStaging(pin=True)
    frame = (8, 1024, 1024, 3)  # 24 MiB a clip: 10 fit under PIN_BYTES
    held = [staging.take(6, frame), staging.take(6, frame)]
    assert held[0].is_pinned() and not held[1].is_pinned()
    assert staging.pinned_bytes == held[0].numel() <= temporal_engine.PIN_BYTES
    staging.take(1, (8, 32, 32, 3))  # another shape: the held pinned one is dropped on return
    staging.give(held[0])
    assert staging.pinned_bytes == 8 * 32 * 32 * 3
