"""MViTv2-S 16x4 (``model_type: mvitv2_s``) against its plain fp32 reference,
on the CPU.

The reference (``tests/plain_mvit.py``, a byte-for-byte copy of the
benchmark's ``benchmark/reference/mvit.py``) reads the same PySlowFast
``model_state`` and materialises the relative-position bias as PySlowFast
does. The program runs a small spec (embed 16, depth 4, the width, the
heads and the q stride doubling at blocks 1 and 3, T 4 at 64 x 64) built by
the same code as the published one.

Tolerances, as ``logit_err``: the largest |program - reference| over a
clip's logits over the standard deviation of that clip's reference logits,
in %, the benchmark check's measure.

* fp32: 0.01% (1e-4 relative): the two sum the same products in another
  order and add the three relative-position tables in another order
  (readings about 0.0002%).
* bf16: 12%: every linear's, pool's and LayerNorm's operands and output,
  and the plain route's logits (values up to about 10, so 2^-9 of them is
  a few hundredths of a logit) and softmax weights are rounded to bf16,
  three dozen roundings deep at this spec; readings 3.5-9.8% on ten seeds.
* Controls, which must exceed the bf16 tolerance: the weights rounded
  through ``float8_e4m3fn`` (the next precision below bf16; reading 29%),
  and, by over three times the tolerance, the program with a branch taken
  out: the relative-position bias (60%), residual pooling (193%), the
  pooled k (its pools zeroed: every key alike; 234%), the pooled v
  (likewise: every value alike; 376%).

The B8 kernel runs only on the card (``tests/test_torch_kernels_cuda.py``);
here its CPU version, the plain route, is held to PySlowFast's own
materialisation (the reference's ``cal_rel_pos_spatial`` and
``cal_rel_pos_temporal``) at every block shape of the published model.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import plain_mvit as plain  # noqa: E402

from realtime_analytics_tpu_torch.config import (  # noqa: E402
    ConfigError,
    DetectorConfig,
    StreamConfig,
)
from realtime_analytics_tpu_torch.engine import export as export_mod  # noqa: E402
from realtime_analytics_tpu_torch.engine import temporal as temporal_engine  # noqa: E402
from realtime_analytics_tpu_torch.engine.detector import create_detector  # noqa: E402
from realtime_analytics_tpu_torch.engine.temporal import NORM_045, TorchTemporalEngine  # noqa: E402
from realtime_analytics_tpu_torch.models import mvit, weights  # noqa: E402
from realtime_analytics_tpu_torch.models.mvit import MViT, MViTSpec, fused_attentions  # noqa: E402
from realtime_analytics_tpu_torch.models.temporal import build_temporal  # noqa: E402
from realtime_analytics_tpu_torch.ops.attention import (  # noqa: E402
    rel_pos_attention,
    rel_pos_attention_plain,
    rel_pos_bias,
)
from realtime_analytics_tpu_torch.types import FramePacket  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(REPO, "benchmark", "configs", "mvitv2-s-16x4-224-bf16.json")) as _f:
    PUBLISHED = json.load(_f)  # the reference's configuration
SMALL = MViTSpec(depth=4, embed_dim=16, stages=(1, 3), num_frames=4, crop=64)
SMALL_REF = {**PUBLISHED, "depth": 4, "embed_dim": 16, "num_frames": 4, "crop_size": 64,
             "dim_mul": [[1, 2.0], [3, 2.0]], "head_mul": [[1, 2.0], [3, 2.0]],
             "pool_q_stride": [[0, 1, 1, 1], [1, 1, 2, 2], [2, 1, 1, 1], [3, 1, 2, 2]]}
FP32_TOL, BF16_TOL = 0.01, 12.0  # logit_err, %


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


def clips_u8(seed, n=3, t=4, hw=64):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, t, hw, hw, 3), generator=g, dtype=torch.uint8)


def normalised(clips):
    """The engine's input to the model: RGB, [0, 1], mean/std 0.45/0.225."""
    return (clips.to(torch.float32).flip(-1) * (1.0 / 255.0) - 0.45) / 0.225


def program(sd, spec=SMALL, dtype=torch.float32):
    model = MViT(spec).eval()
    weights.temporal_params_from_jax(model, weights.mvit_params_from_state_dict(model, sd))
    return model.to(dtype)


def run(model, clips, dtype=torch.float32):
    with torch.no_grad():
        return model(normalised(clips).to(dtype)).float()


@pytest.fixture(scope="module")
def seeded():
    sd = weights.mvit_seeded_state_dict(SMALL, seed=11)
    clips = clips_u8(11)
    return sd, clips, plain.logits(plain.MViT(SMALL_REF, sd), clips)


def test_fp32_program_matches_the_reference(seeded):
    sd, clips, want = seeded
    assert logit_err(run(program(sd), clips), want) < FP32_TOL


@pytest.mark.parametrize("seed", [11, 12, 13, 14])
def test_bf16_program_within_its_tolerance(seed):
    sd = weights.mvit_seeded_state_dict(SMALL, seed=seed)
    clips = clips_u8(seed)
    want = plain.logits(plain.MViT(SMALL_REF, sd), clips)
    got = run(program(sd, dtype=torch.bfloat16), clips, torch.bfloat16)
    assert logit_err(got, want) < BF16_TOL


def _no_residual(q, k, v, rel_t, rel_h, rel_w, scale):
    out = rel_pos_attention_plain(q, k, v, rel_t, rel_h, rel_w, scale)
    res = q.clone()
    res[:, :, 0] = 0
    return out - res.transpose(1, 2).reshape(out.shape)


@pytest.mark.parametrize("control", ["float8_e4m3fn", "no_rel_pos", "no_residual_pooling",
                                     "k_pool_zeroed", "v_pool_zeroed"])
def test_controls_fail_the_comparison(seeded, monkeypatch, control):
    """The fp8 control reads over the bf16 tolerance, each branch taken out
    over three times it: the seeded scales keep every branch live
    (``mvit_seeded_state_dict``)."""
    sd, clips, want = seeded
    if control == "float8_e4m3fn":
        sd = {k: v.to(torch.float8_e4m3fn).float() if v.dim() >= 2 else v for k, v in sd.items()}
    if control in ("k_pool_zeroed", "v_pool_zeroed"):
        name = "pool_k" if control == "k_pool_zeroed" else "pool_v"
        sd = {k: v * 0 if f".{name}." in k else v for k, v in sd.items()}
    if control == "no_rel_pos":
        monkeypatch.setattr(mvit, "rel_tables", lambda q, qs, ks, t, i: [
            q.new_zeros(*q.shape[:2], q.shape[2] - 1, n) for n in ks])
    if control == "no_residual_pooling":
        monkeypatch.setattr(mvit, "rel_pos_attention_plain", _no_residual)
    got = run(program(sd, dtype=torch.bfloat16), clips, torch.bfloat16)
    assert logit_err(got, want) > (1 if control == "float8_e4m3fn" else 3) * BF16_TOL


@pytest.mark.parametrize("shape", [*sorted({(s.heads, s.q_thw, s.kv_thw)
                                            for s in MViTSpec().blocks()}),
                                   (3, (2, 5, 5), (1, 3, 3))])
def test_b8_cpu_version_equals_pyslowfasts_materialisation(shape):
    """B8's CPU version (the wrapper and the registered op) on the port's
    tables against the reference's attention with PySlowFast's
    ``cal_rel_pos_spatial`` and ``cal_rel_pos_temporal``, at every block
    shape of the published model (one clip; fp32)."""
    heads, q_thw, kv_thw = shape
    g = torch.Generator().manual_seed(sum(q_thw) + heads)
    nq, nk, d = 1 + math.prod(q_thw), 1 + math.prod(kv_thw), 96
    q, k, v = (torch.randn(1, heads, n, d, generator=g) for n in (nq, nk, nk))
    size = max(q_thw[1], kv_thw[1])
    tables = (torch.randn(2 * max(q_thw[0], kv_thw[0]) - 1, d, generator=g) * 0.1,
              torch.randn(2 * size - 1, d, generator=g) * 0.1,
              torch.randn(2 * size - 1, d, generator=g) * 0.1)
    scale = d ** -0.5
    attn = (q * scale) @ k.transpose(-2, -1)
    attn = plain.cal_rel_pos_spatial(attn, q, q_thw, kv_thw, tables[1], tables[2])
    attn = plain.cal_rel_pos_temporal(attn, q, q_thw, kv_thw, tables[0])
    want = attn.softmax(dim=-1) @ v
    want[:, :, 1:] += q[:, :, 1:]
    want = want.transpose(1, 2).reshape(1, nq, heads * d)
    rel = mvit.rel_tables(q, q_thw, kv_thw, tables,
                          [mvit.rel_index(a, b) for a, b in zip(q_thw, kv_thw)])
    torch.testing.assert_close(rel_pos_attention(q, k, v, *rel, scale), want,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.ops.rva.rel_pos_attention(q, k, v, *rel, scale), want,
                               rtol=1e-5, atol=1e-5)


def onehot_keys(kt, kh, kw):
    """B8's E (``csrc/attention.cu``, ``build_onehot``): key j > 0 at (t, h,
    w) has ones at columns t, k_t + h and k_t + k_h + w; the cls key none."""
    e = torch.zeros(1 + kt * kh * kw, kt + kh + kw)
    for j in range(1, e.shape[0]):
        t, rest = divmod(j - 1, kh * kw)
        h, w = divmod(rest, kw)
        e[j, t] = e[j, kt + h] = e[j, kt + kh + w] = 1
    return e


@pytest.mark.parametrize("kv", [(8, 7, 7), (8, 14, 14), (1, 2, 3)])
def test_b8_bias_is_the_tables_times_one_hot_keys(kv):
    """B8 adds the bias as a product on the tensor cores: a row's three
    tables side by side times the key tile's one-hot columns. Replayed here,
    that product is the materialised bias at every key past cls, and 0 at
    cls."""
    g = torch.Generator().manual_seed(sum(kv))
    rel = [torch.randn(2, 3, 5, n, generator=g) for n in kv]
    got = torch.cat(rel, dim=-1) @ onehot_keys(*kv).T
    assert torch.equal(got[..., 0], torch.zeros(2, 3, 5))
    torch.testing.assert_close(got[..., 1:], rel_pos_bias(*rel), rtol=1e-6, atol=1e-6)


def test_pools_take_contiguous_ncdhw_inputs(monkeypatch):
    """Every q, k and v pool reads a contiguous NCDHW grid, with one head as
    with several: a view in ``channels_last_3d`` strides (what the reshape
    alone gives with one head) sends the card's depthwise conv to cuDNN's
    generic GEMM, 11-33 times slower."""
    seen = []
    conv3d = torch.nn.functional.conv3d

    def spy(x, w, *args, **kwargs):
        if w.shape[1] == 1:  # a depthwise pool, not the patch embedding
            seen.append(x.is_contiguous())
        return conv3d(x, w, *args, **kwargs)

    monkeypatch.setattr(torch.nn.functional, "conv3d", spy)
    run(program(weights.mvit_seeded_state_dict(SMALL, seed=2)), clips_u8(2, n=1))
    assert len(seen) == 3 * SMALL.depth and all(seen)


def test_rel_index_is_pyslowfasts_distance():
    for q_n, k_n in ((56, 7), (28, 14), (14, 14), (7, 14), (8, 8), (3, 2)):
        assert torch.equal(mvit.rel_index(q_n, k_n), plain.rel_dist(q_n, k_n))
        assert int(mvit.rel_index(q_n, k_n).max()) < 2 * max(q_n, k_n) - 1  # the table's rows


# -- the published spec ----------------------------------------------------------


def test_published_spec_parameter_count():
    with torch.device("meta"):
        model = MViT(MViTSpec())
    assert sum(p.numel() for p in model.parameters()) == 34_537_744


def test_flops_per_clip_of_the_published_spec():
    flops = plain.flops_per_clip(PUBLISHED)
    assert flops == PUBLISHED["flops_per_clip"]
    assert abs(flops - 2 * 64.6e9) / (2 * 64.6e9) < 0.01


def test_block_token_shapes_are_the_published_ones():
    """(q tokens, k/v tokens, heads) with cls, block by block."""
    want = ([(25089, 393, 1), (6273, 1569, 2), (6273, 393, 2), (1569, 1569, 4)]
            + [(1569, 393, 4)] * 10 + [(393, 1569, 8), (393, 393, 8)])
    got = [(1 + math.prod(s.q_thw), 1 + math.prod(s.kv_thw), s.heads) for s in MViTSpec().blocks()]
    assert got == want
    ref = [(1 + math.prod(g["q"]), 1 + math.prod(g["kv"]), g["heads"])
           for g in plain.token_grids(PUBLISHED)]
    assert ref == want
    assert {s.head_dim for s in MViTSpec().blocks()} == {96}


def test_the_ports_layout_is_the_references():
    assert list(weights.mvit_manifest().items()) == list(plain.manifest(PUBLISHED).items())
    assert list(weights.mvit_manifest(SMALL).items()) == list(plain.manifest(SMALL_REF).items())


def test_reference_copies_are_byte_identical():
    with open(os.path.join(REPO, "tests", "plain_mvit.py"), "rb") as a, \
            open(os.path.join(REPO, "benchmark", "reference", "mvit.py"), "rb") as b:
        assert a.read() == b.read()


def test_a_missing_key_raises():
    sd = weights.mvit_seeded_state_dict(SMALL, seed=1)
    del sd["blocks.2.attn.rel_pos_t"]
    with pytest.raises(KeyError):
        weights.mvit_params_from_state_dict(MViT(SMALL), sd)


def test_build_temporal_sizes_the_tables_from_the_clip():
    model = build_temporal("mvitv2_s", 400, t_len=16, crop=224)
    assert isinstance(model, MViT) and model.spec == MViTSpec()
    small = build_temporal("mvitv2_s", 10, t_len=8, crop=96)
    assert small.blocks[0].attn.rel_pos_t.shape == (7, 96)
    assert small.blocks[0].attn.rel_pos_h.shape == (2 * 24 - 1, 96)


def test_config_refuses_what_mvit_cannot_take():
    cfg = DetectorConfig(model_type="mvitv2_s", sequence_length=16, sequence_stride=4)
    cfg.validate()
    assert cfg.resolved_input_size == (224, 224) and "mvitv2_s" in NORM_045
    with pytest.raises(ConfigError, match="even sequence_length"):
        DetectorConfig(model_type="mvitv2_s", sequence_length=15).validate()
    with pytest.raises(ConfigError, match="multiple of 32"):
        DetectorConfig(model_type="mvitv2_s", input_size=[200, 200]).validate()
    with pytest.raises(ConfigError, match="square"):
        DetectorConfig(model_type="mvitv2_s", input_size=[224, 256]).validate()
    with pytest.raises(ConfigError, match="mesh_shape"):
        DetectorConfig(model_type="mvitv2_s", mesh_shape=[2, 1]).validate()


@pytest.mark.parametrize("device,precision,half,refused", [
    ("auto", "fp32", False, True), ("cuda", "fp32", False, True),
    ("cuda:0", "int8", False, True), ("cuda", "int8", True, True),
    ("auto", "bf16", False, False), ("cuda:0", "fp32", True, False),
    ("cpu", "fp32", False, False), ("cpu", "bf16", False, False)])
def test_config_refuses_mvit_off_bf16_on_the_card(device, precision, half, refused):
    """On a CUDA device (``auto`` never falls back to the CPU) every block's
    attention is B8, which takes bf16 alone: another compute dtype is
    refused before an engine is built, not served on the plain route."""
    cfg = DetectorConfig(model_type="mvitv2_s", device=device, precision=precision, half=half)
    if refused:
        with pytest.raises(ConfigError, match="bf16"):
            cfg.validate()
    else:
        cfg.validate()


# -- the engine ------------------------------------------------------------------

ENGINE_SPEC = MViTSpec(depth=4, embed_dim=16, stages=(1, 3), num_frames=16, crop=64)
ENGINE_REF = {**SMALL_REF, "num_frames": 16}


@pytest.fixture
def small_engine(monkeypatch, tmp_path):
    """An ``mvitv2_s`` engine on the CPU at the small spec, T 16 at stride
    4, 64 x 64 frames, from a PySlowFast checkpoint file."""
    monkeypatch.setattr(temporal_engine, "build_temporal", lambda *a, **k: MViT(ENGINE_SPEC))
    sd = weights.mvit_seeded_state_dict(ENGINE_SPEC, seed=21)
    path = str(tmp_path / "mvitv2_s.pyth")
    torch.save({"model_state": sd, "epoch": 200}, path)
    cfg = DetectorConfig(model_path=path, model_type="mvitv2_s", device="cpu",
                         precision="fp32", input_size=[64, 64], sequence_length=16,
                         sequence_stride=4, temporal_overlap=0.0, batch_buckets=[2],
                         max_batch_size=2, confidence_threshold=1e-6, warmup=False)
    eng = create_detector(cfg)
    assert isinstance(eng, TorchTemporalEngine) and isinstance(eng.model, MViT)
    return eng, plain.MViT(ENGINE_REF, sd)


def window(seed, n=64, hw=64):
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
    clip = torch.from_numpy(frames[::4][None])  # frames 0, 4, ..., 60
    want = plain.logits(ref, clip)
    probs, classes = torch.topk(torch.softmax(want, 1), 5)
    assert [d.class_id for d in dets] == classes[0].tolist()
    np.testing.assert_allclose([d.confidence for d in dets], probs[0].numpy(), rtol=1e-4)
    assert (dets[0].sequence_start_frame, dets[0].sequence_end_frame) == (0, 60)
    seq = [packets[i] for i in range(0, 64, 4)]
    got_dets, logits = eng.predict_clips([seq], return_logits=True)
    assert logits.shape == (1, 400) and logits.dtype == np.float32
    assert logit_err(logits, want) < FP32_TOL


def test_cpu_engine_fuses_no_attention(small_engine):
    eng, _ = small_engine
    frames = window(5)
    stream = StreamConfig(name="cam-4")
    eng.predict_clips([[FramePacket(stream, frames[4 * i], i, 0.0) for i in range(16)]])
    assert eng.stats.calls >= 1
    assert eng.stats.fused_attentions == 0 == fused_attentions(eng.model)
    assert eng.stats.stacked_convs == 0


def test_other_clip_models_count_no_fused_attention():
    cfg = DetectorConfig(model_type="3d_cnn", device="cpu", precision="fp32",
                         input_size=[32, 32], sequence_length=4, batch_buckets=[1],
                         max_batch_size=1, warmup=False, model_path="none.pt")
    eng = create_detector(cfg)
    frames = window(6, n=4, hw=32)
    eng.predict_clips([[FramePacket(StreamConfig(name="c"), f, i, 0.0)
                        for i, f in enumerate(frames)]])
    assert eng.stats.fused_attentions == 0


def test_export_refuses_mvit(small_engine, tmp_path):
    eng, _ = small_engine
    with pytest.raises(ValueError, match="mvitv2_s"):
        export_mod.export_serving_artifact(eng, str(tmp_path / "m.rvae"), [(64, 64)])
