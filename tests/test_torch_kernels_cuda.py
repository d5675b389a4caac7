"""Each hand-written CUDA kernel against its plain PyTorch version, on the card.

These need an NVIDIA Hopper card and nvcc; they carry the ``cuda`` marker
and skip elsewhere. Run them on a machine with the card:

    python -m pytest -m cuda tests/test_torch_kernels_cuda.py

Whether a card is present is decided inside the ``card`` fixture, never at
import time, so every pytest-xdist worker collects the same tests.
B2, B3 and B4 each run both of their instantiations (``decode_instantiation``,
``stem_instantiation`` and ``letterbox_instantiation`` say which a case
takes). Tolerances: B1 bit-exact; B2 boxes atol 1e-3 px, conf atol 1e-5, classes
exact; B3 fp32 atol 1e-4, bf16 within 1% of the output range (P1 is rounded
to bf16 in both versions; accumulation order may flip one rounding); B4 pad
exact, content within one uint8 level (plus one bf16 ulp in bf16) on under
1% of the pixels, and at the new shapes bit for bit: both versions run the
same tables in the same fp32 order without FMA contraction, and a tap of
weight 0 that the kernel leaves out changes no bit; B6 bit-equal (a boolean
mask: greedy is the fixpoint's unique solution), from the boxes and from an
overlap matrix; B8 against the plain route computed in fp32 from the same
bf16 operands, within 0.02 + 1% of the output's largest magnitude at every
element (the kernel rounds the softmax weights to bf16 for the PV product,
2^-9 of a weight, and its output once to bf16, 2^-9 of up to |q| + |v|; the
sums run in another order), and its mean error within 2e-3. Each
registered ``rva`` op on CUDA tensors equals its wrapper bit for bit and
counts one launch. The published MViTv2-S forward in bf16 on two clips
against the plain fp32 reference (``tests/plain_mvit.py``): within the
benchmark cell's limits.
"""

import json
import math
import os
import sys

import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.models.mvit import MViTSpec
from realtime_analytics_tpu_torch.ops import _cuda
from realtime_analytics_tpu_torch.ops.attention import (
    rel_pos_attention,
    rel_pos_attention_plain,
)
from realtime_analytics_tpu_torch.ops.decode import (
    decode_instantiation,
    decode_v8_level,
    decode_v8_level_plain,
    decode_v8_levels,
    decode_v8_levels_plain,
)
from realtime_analytics_tpu_torch.ops.gather import row_gather, row_gather_plain
from realtime_analytics_tpu_torch.ops.letterbox import (
    letterbox,
    letterbox_instantiation,
    letterbox_operands,
    letterbox_plain,
    letterbox_plan,
    stretch_spec,
)
from realtime_analytics_tpu_torch.ops import nms as nms_mod
from realtime_analytics_tpu_torch.ops.nms import (
    batched_nms,
    mask_words,
    nms_keep,
    nms_keep_boxes,
    nms_keep_boxes_plain,
    nms_keep_plain,
    scratch_chunk,
)
from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec
from realtime_analytics_tpu_torch.ops.stem import (
    fused_stem_p1p2,
    fused_stem_p1p2_plain,
    prepare_stem,
    stem_instantiation,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the H100 machine)")
    if torch.cuda.get_device_capability(0) < (9, 0):
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cudnn.allow_tf32 = False
    _cuda.lib()  # build once for the module
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n,m,p,k", [
    (32, 8400, 4, 512), (32, 512, 6, 300), (3, 100, 6, 7),
    (4, 1000, 1, 130),   # 4-byte rows; k not a multiple of the block
    (1, 8400, 4, 512),   # n = 1, 16-byte rows
    (2, 777, 5, 129),    # odd width: 4-byte moves
    (5, 64, 6, 1),       # 8-byte moves, one row a batch
])
def test_row_gather_bit_exact(card, n, m, p, k):
    g = torch.Generator(device=card).manual_seed(n + m + p + k)
    payload = torch.randn(n, m, p, generator=g, device=card) * 640
    bits = payload.view(torch.int32).view(-1)
    # a NaN with a payload, -0.0, +inf, the smallest denormal
    bits[:4] = torch.tensor([0x7FC01234, -(2**31), 0x7F800000, 1], device=card,
                            dtype=torch.int32)
    idx = torch.randint(0, m, (n, k), generator=g, device=card)
    idx[:, 0], idx[:, -1] = 0, m - 1
    before = _cuda.LAUNCHES.snapshot()["row_gather"]
    got = row_gather(payload, idx)
    assert _cuda.LAUNCHES.snapshot()["row_gather"] == before + 1
    want = row_gather_plain(payload, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_row_gather_unaligned_view_bit_exact(card):
    """A contiguous payload that starts 4 bytes into its storage: the
    16-byte path's alignment does not hold, the copy is still exact."""
    g = torch.Generator(device=card).manual_seed(7)
    flat = torch.randn(2 * 50 * 4 + 1, generator=g, device=card)
    payload = flat[1:].view(2, 50, 4)
    idx = torch.randint(0, 50, (2, 9), generator=g, device=card)
    got, want = row_gather(payload, idx), row_gather_plain(payload, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_row_gather_rejects_what_it_does_not_take(card):
    payload = torch.zeros(2, 10, 4, device=card)
    idx = torch.zeros(2, 3, dtype=torch.int64, device=card)
    before = _cuda.LAUNCHES.snapshot()["row_gather"]
    with pytest.raises(TypeError):
        row_gather(payload, idx.int())
    with pytest.raises(TypeError):  # a CUDA tensor of the wrong dtype
        row_gather(payload.half(), idx)
    with pytest.raises(TypeError):
        row_gather(payload.double(), idx)
    with pytest.raises(ValueError):
        row_gather(payload[:, ::2], idx)
    with pytest.raises(ValueError):  # one tensor on the card, one not
        row_gather(payload, idx.cpu())
    with pytest.raises(ValueError):
        row_gather(payload[0], idx)
    assert _cuda.LAUNCHES.snapshot()["row_gather"] == before  # nothing was launched


@pytest.mark.parametrize("h,w,nc,dtype", [
    (80, 80, 80, torch.bfloat16), (40, 40, 80, torch.float32), (5, 7, 17, torch.bfloat16),
])
def test_decode_matches_plain(card, h, w, nc, dtype):
    g = torch.Generator(device=card).manual_seed(h * w + nc)
    box = (torch.randn(4, h, w, 64, generator=g, device=card) * 3).to(dtype)
    cls = (torch.randn(4, h, w, nc, generator=g, device=card) * 3).to(dtype)
    cls[:, 0] = 0  # every class tied: the first wins
    got = decode_v8_level(box, cls, stride=8.0)
    want = decode_v8_level_plain(box, cls, stride=8.0)
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    assert torch.equal(got[2], want[2])
    assert bool((got[2][:, :w] == 0).all())


def test_decode_requires_nhwc_contiguous(card):
    box = torch.zeros(1, 64, 4, 4, device=card).permute(0, 2, 3, 1)  # NCHW-contig
    cls = torch.zeros(1, 4, 4, 80, device=card)
    with pytest.raises(ValueError):
        decode_v8_level(box, cls, stride=8.0)


def _head(card, seed, n, shapes, nc, dtype):
    g = torch.Generator(device=card).manual_seed(seed)
    return [((torch.randn(n, h, w, 64, generator=g, device=card) * 3).to(dtype),
             (torch.randn(n, h, w, nc, generator=g, device=card) * 3).to(dtype))
            for h, w in shapes]


def _hold_levels(levels, strides, kind):
    dtype, nc = levels[0][0].dtype, levels[0][1].shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for lvl in levels for t in lvl)
    assert decode_instantiation(dtype, nc, aligned) == kind
    before = _cuda.LAUNCHES.snapshot()["decode_v8"]
    got = decode_v8_levels(levels, strides)
    assert _cuda.LAUNCHES.snapshot()["decode_v8"] == before + 1  # one launch a head
    want = decode_v8_levels_plain(levels, strides)
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0)
    assert torch.equal(got[2], want[2]) and got[2].dtype == torch.int32
    return got


@pytest.mark.parametrize("n,shapes,nc,dtype,kind", [
    (4, ((80, 80), (40, 40), (20, 20)), 80, torch.bfloat16, "vec16"),  # the main path's head
    (2, ((40, 40), (20, 20), (10, 10)), 80, torch.float32, "vec16"),
    (3, ((9, 13), (5, 7), (3, 2), (1, 1)), 80, torch.bfloat16, "vec16"),  # ragged, 4 levels
    (3, ((9, 13), (5, 7)), 3, torch.bfloat16, "element"),     # fewer classes than lanes
    (2, ((8, 8), (4, 4), (2, 2)), 81, torch.float32, "element"),
    (2, ((8, 8), (4, 4)), 84, torch.bfloat16, "element"),     # nc % 8
    (2, ((8, 8), (4, 4)), 104, torch.bfloat16, "vec16"),      # 13 chunks: a second batch
    (2, ((8, 8),), 200, torch.float32, "vec16"),              # 50 chunks
    (1, ((1, 1),), 8, torch.bfloat16, "vec16"),               # one anchor, one chunk
])
def test_decode_levels_match_plain(card, n, shapes, nc, dtype, kind):
    levels = _head(card, n + nc, n, shapes, nc, dtype)
    for _, cls in levels:
        cls[:, 0] = 0                       # every class tied: the first wins
        if nc > 8 and cls.shape[1] > 1:
            cls[:, 1, :, [7, 8]] = 40.0     # a tie across two lanes' chunks
    got = _hold_levels(levels, (8.0, 16.0, 32.0, 64.0)[:len(shapes)], kind)
    w0 = shapes[0][1]
    assert bool((got[2][:, :w0] == 0).all())
    if nc > 8 and shapes[0][0] > 1:
        assert bool((got[2][:, w0:2 * w0] == 7).all())


def test_decode_levels_unaligned_view(card):
    """Class logits that start 2 bytes into their storage: the 16-byte
    loads' alignment does not hold, the element instantiation runs."""
    g = torch.Generator(device=card).manual_seed(3)
    flat = (torch.randn(2 * 6 * 6 * 80 + 1, generator=g, device=card) * 3).bfloat16()
    box = (torch.randn(2, 6, 6, 64, generator=g, device=card) * 3).bfloat16()
    _hold_levels([(box, flat[1:].view(2, 6, 6, 80))], (8.0,), "element")


def test_decode_levels_nan_and_inf_logits(card):
    """NaN is the greatest class logit and the first NaN wins, as in
    torch.argmax; NaN and inf come out where the plain version has them."""
    (box, cls), = _head(card, 9, 2, ((8, 8),), 80, torch.float32)
    box[0, 0, 0, :16], box[0, 0, 0, 0] = -100.0, 100.0
    box[0, 1, 0, 3], box[0, 1, 1, 20] = float("inf"), float("nan")
    cls[0, 2, 0, 50], cls[0, 2, 1, [5, 60]] = float("nan"), float("nan")
    cls[0, 2, 2, 9], cls[0, 2, 3] = float("inf"), -float("inf")
    got = decode_v8_levels([(box, cls)], (8.0,))
    want = decode_v8_levels_plain([(box, cls)], (8.0,))
    torch.testing.assert_close(got[0], want[0], atol=1e-3, rtol=0, equal_nan=True)
    torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=0, equal_nan=True)
    assert torch.equal(got[2], want[2])
    assert got[2][0, 16].item() == 50 and got[2][0, 17].item() == 5


def test_decode_levels_reject_what_they_do_not_take(card):
    (box, cls), = _head(card, 1, 1, ((4, 4),), 80, torch.bfloat16)
    before = _cuda.LAUNCHES.snapshot()["decode_v8"]
    with pytest.raises(ValueError):  # five levels
        decode_v8_levels([(box, cls)] * 5, [8.0] * 5)
    with pytest.raises(ValueError):  # a stride short
        decode_v8_levels([(box, cls)] * 2, [8.0])
    with pytest.raises(TypeError):
        decode_v8_levels([(box, cls.float())], [8.0])
    with pytest.raises(TypeError):
        decode_v8_levels([(box.half(), cls.half())], [8.0])
    with pytest.raises(ValueError):  # one tensor on the card, one not
        decode_v8_levels([(box, cls.cpu())], [8.0])
    with pytest.raises(ValueError):  # class grid differs from the box grid
        decode_v8_levels([(box, cls[:, :2])], [8.0])
    with pytest.raises(ValueError):  # not contiguous
        decode_v8_levels([(box, cls[..., ::2])], [8.0])
    assert _cuda.LAUNCHES.snapshot()["decode_v8"] == before  # nothing was launched


@pytest.mark.parametrize("dtype,n,h,w,c0,c1,kind", [
    (torch.bfloat16, 4, 640, 640, 16, 32, "mma"),
    (torch.float32, 2, 128, 96, 16, 32, "general"),
    (torch.float32, 2, 68, 36, 32, 64, "general"),  # ragged tiles (H/4, W/4 off the tile)
    (torch.bfloat16, 2, 640, 640, 32, 64, "mma"),   # v8s
    (torch.bfloat16, 1, 640, 640, 16, 32, "mma"),
    (torch.bfloat16, 3, 360, 640, 16, 32, "mma"),   # non-square, ragged tile rows
    (torch.bfloat16, 3, 72, 40, 16, 32, "mma"),     # ragged tile rows and columns
    (torch.bfloat16, 1, 64, 64, 48, 96, "mma"),     # v8m widths
    (torch.bfloat16, 2, 64, 64, 16, 24, "mma"),     # a 3-tile channel chunk
    (torch.bfloat16, 2, 64, 64, 8, 24, "general"),  # widths off the fragment multiples
    (torch.bfloat16, 2, 64, 68, 16, 32, "general"),  # W * 6 bytes not 16-byte aligned
    (torch.float32, 3, 360, 640, 16, 32, "general"),
    (torch.float32, 1, 64, 64, 6, 10, "general"),   # widths off multiples of 4
])
def test_stem_matches_plain(card, dtype, n, h, w, c0, c1, kind):
    assert stem_instantiation(dtype, c0, c1, w) == kind
    g = torch.Generator(device=card).manual_seed(h + w + c0)
    sw = prepare_stem(
        torch.randn(c0, 3, 3, 3, generator=g, device=card) * 0.3 / 255,
        torch.randn(c0, generator=g, device=card) * 0.1,
        torch.randn(c1, c0, 3, 3, generator=g, device=card) * (2 / (9 * c0)) ** 0.5,
        torch.randn(c1, generator=g, device=card) * 0.1,
        dtype,
    )
    x = torch.randint(0, 256, (n, h, w, 3), generator=g, device=card).to(dtype)
    before = _cuda.LAUNCHES.snapshot()["fused_stem"]
    got = fused_stem_p1p2(x, sw).float()
    assert _cuda.LAUNCHES.snapshot()["fused_stem"] == before + 1
    want = fused_stem_p1p2_plain(x, sw).float()
    assert got.shape == (n, h // 4, w // 4, c1)
    err = (got - want).abs().max().item()
    tol = 1e-2 * want.abs().max().item() if dtype == torch.bfloat16 else 1e-4
    assert err <= tol, err
    assert np.isfinite(got.cpu().numpy()).all()


def test_stem_rejects_what_it_does_not_take(card):
    sw = prepare_stem(torch.zeros(16, 3, 3, 3, device=card), torch.zeros(16, device=card),
                      torch.zeros(32, 16, 3, 3, device=card), torch.zeros(32, device=card),
                      torch.bfloat16)
    x = torch.zeros(1, 64, 64, 3, device=card)
    with pytest.raises(TypeError):  # fp32 input against bf16 weights
        fused_stem_p1p2(x, sw)
    with pytest.raises(TypeError):
        fused_stem_p1p2(x.half(), sw)
    with pytest.raises(ValueError):  # H % 4
        fused_stem_p1p2(x.bfloat16()[:, :62], sw)
    with pytest.raises(ValueError):  # not contiguous
        fused_stem_p1p2(torch.zeros(1, 64, 128, 3, device=card).bfloat16()[:, :, ::2], sw)
    with pytest.raises(ValueError):  # a contiguous view 2 bytes into its storage
        flat = torch.zeros(64 * 64 * 3 + 1, device=card).bfloat16()
        fused_stem_p1p2(flat[1:].view(1, 64, 64, 3), sw)


@pytest.mark.parametrize("src_hw,dst_hw,stretch,dtype", [
    ((1080, 1920), (640, 640), False, torch.bfloat16),  # H select
    ((720, 1280), (640, 640), False, torch.bfloat16),   # H mean2
    ((1520, 2688), (640, 640), False, torch.bfloat16),  # H fractional
    ((1080, 1920), (224, 224), True, torch.float32),    # the ResNet stretch
    ((75, 131), (128, 128), False, torch.float32),      # upscale, pad on both axes
])
def test_letterbox_matches_plain(card, src_hw, dst_hw, stretch, dtype):
    g = torch.Generator(device=card).manual_seed(src_hw[0] + dst_hw[0])
    frames = torch.randint(0, 256, (4, *src_hw, 3), generator=g, device=card,
                           dtype=torch.uint8)
    spec = stretch_spec(src_hw, dst_hw) if stretch else letterbox_spec(src_hw, dst_hw)
    before = _cuda.LAUNCHES.snapshot()["letterbox"]
    got = letterbox(frames, spec, dtype)
    assert _cuda.LAUNCHES.snapshot()["letterbox"] == before + 1
    want = letterbox_plain(frames, spec, dtype)
    assert got.shape == want.shape and got.dtype == dtype and got.is_contiguous()
    content = torch.zeros(dst_hw, dtype=torch.bool, device=card)
    content[spec.pad_top:spec.pad_top + spec.new_h, spec.pad_left:spec.pad_left + spec.new_w] = True
    assert torch.equal(got[:, ~content], want[:, ~content])
    diff = (got.float() - want.float()).abs()[:, content]
    tol = 1.0 / 255.0 + (2.0 ** -8 if dtype == torch.bfloat16 else 1e-6)
    assert diff.max().item() <= tol
    assert (diff.amax(-1) > 0).float().mean().item() < 0.01


@pytest.mark.parametrize("src_hw,dst_hw,stretch,dtype,kind,dense", [
    ((97, 211), (128, 128), False, torch.bfloat16, "element", True),   # 633-byte rows
    ((97, 211), (128, 128), False, torch.float32, "element", True),
    ((90, 160), (33, 50), True, torch.bfloat16, "element", True),      # 300-byte output rows
    ((48, 40), (64, 64), True, torch.bfloat16, "element", True),       # upscale: shared taps
    ((48, 64), (64, 64), True, torch.float32, "vec16", True),
    ((1080, 1920), (224, 224), True, torch.float32, "vec16", False),   # taps read in place
    ((1080, 1920), (112, 112), True, torch.float32, "vec16", False),
    ((1080, 1920), (112, 112), True, torch.bfloat16, "vec16", False),
    ((500, 300), (128, 128), False, torch.bfloat16, "element", True),  # pad left and right
    ((16, 4096), (4, 2000), True, torch.float32, "vec16", True),       # two segments a row
    ((1080, 1920), (640, 640), False, torch.float32, "vec16", True),
])
def test_letterbox_bit_equal_to_plain(card, src_hw, dst_hw, stretch, dtype, kind, dense):
    g = torch.Generator(device=card).manual_seed(src_hw[1] + dst_hw[1])
    frames = torch.randint(0, 256, (3, *src_hw, 3), generator=g, device=card,
                           dtype=torch.uint8)
    spec = stretch_spec(src_hw, dst_hw) if stretch else letterbox_spec(src_hw, dst_hw)
    assert letterbox_instantiation(spec.src_w, spec.dst_w, dtype, True) == kind
    assert letterbox_plan(spec, dtype, kind).dense == dense
    got, want = letterbox(frames, spec, dtype), letterbox_plain(frames, spec, dtype)
    assert got.dtype == dtype and got.is_contiguous()
    assert torch.equal(got, want)


def test_letterbox_unaligned_frames_bit_equal(card):
    """Frames that start one byte into their storage take the element
    instantiation, whatever their width."""
    g = torch.Generator(device=card).manual_seed(5)
    flat = torch.randint(0, 256, (2 * 64 * 128 * 3 + 1,), generator=g, device=card,
                         dtype=torch.uint8)
    frames = flat[1:].view(2, 64, 128, 3)
    spec = letterbox_spec((64, 128), (64, 64))
    assert letterbox_instantiation(128, 64, torch.bfloat16, frames.data_ptr() % 16 == 0) \
        == "element"
    assert torch.equal(letterbox(frames, spec), letterbox_plain(frames, spec))


def test_letterbox_rejects_what_it_does_not_take(card):
    spec = letterbox_spec((48, 64), (32, 32))
    with pytest.raises(TypeError):
        letterbox(torch.zeros(1, 48, 64, 3, device=card), spec)
    with pytest.raises(ValueError):
        letterbox(torch.zeros(1, 48, 128, 3, dtype=torch.uint8, device=card)[:, :, ::2], spec)
    with pytest.raises(TypeError):  # an output dtype the kernel does not write
        letterbox(torch.zeros(1, 48, 64, 3, dtype=torch.uint8, device=card), spec, torch.float16)


def _overlaps(card, n, k, p, valid_p, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    s = torch.rand(n, k, k, generator=g, device=card) < p
    valid = torch.rand(n, k, generator=g, device=card) < valid_p
    tri = torch.ones(k, k, dtype=torch.bool, device=card).tril(-1)
    return (s & tri & valid[:, :, None] & valid[:, None, :]).contiguous(), valid


@pytest.mark.parametrize("n,k,p,valid_p", [
    (32, 512, 0.02, 0.9),   # the main path's shape
    (32, 1024, 0.01, 0.9),  # the largest K packed in shared memory
    (4, 2048, 0.005, 0.9),  # rows in the scratch buffer, two words a lane
    (2, 8400, 0.001, 0.9),  # every anchor of a 640 input as a candidate
    (2, 4099, 0.002, 0.9),  # past 4096, K % 16 != 0
    (8, 300, 0.03, 0.9),    # K % 16 != 0: byte reads
    (32, 512, 0.02, 1.0), (32, 512, 0.02, 0.0), (3, 17, 0.5, 0.8),
])
def test_nms_keep_bit_equal_to_plain(card, n, k, p, valid_p):
    ov, valid = _overlaps(card, n, k, p, valid_p, seed=n + k)
    before = _cuda.LAUNCHES.snapshot()["nms_keep"]
    got = nms_keep(ov, valid)
    assert _cuda.LAUNCHES.snapshot()["nms_keep"] == before + 1
    assert torch.equal(got, nms_keep_plain(ov, valid))


def test_nms_keep_on_a_chain(card):
    """Every rank overlaps the one before it: greedy keeps every other."""
    k = 512
    ov = torch.zeros(2, k, k, dtype=torch.bool, device=card)
    ov[:, torch.arange(1, k), torch.arange(k - 1)] = True
    valid = torch.ones(2, k, dtype=torch.bool, device=card)
    got = nms_keep(ov, valid)
    assert torch.equal(got, nms_keep_plain(ov, valid))
    assert torch.equal(got[0].cpu(), torch.arange(k) % 2 == 0)


def test_nms_keep_rejects_what_it_does_not_take(card):
    ov, valid = _overlaps(card, 2, 64, 0.1, 0.9, seed=1)
    before = _cuda.LAUNCHES.snapshot()["nms_keep"]
    with pytest.raises(TypeError):
        nms_keep(ov.float(), valid)
    with pytest.raises(ValueError):
        nms_keep(ov[:, :, :32], valid)
    with pytest.raises(ValueError):
        nms_keep(ov.transpose(1, 2), valid)
    assert _cuda.LAUNCHES.snapshot()["nms_keep"] == before


def _nms_boxes(card, n, k, valid_p, seed, classes=0, nan=False, edge=False):
    """Seeded candidate boxes [n, k, 4] in rank order (class-shifted as
    ``batched_nms`` shifts them when ``classes``), valid [n, k]; ``edge``
    plants pairs whose IoU is exactly f32(0.45) (a 1 x 9 box inside a 1 x
    20), ``nan`` a NaN coordinate."""
    g = torch.Generator(device=card).manual_seed(seed)
    xy = torch.rand(n, k, 2, generator=g, device=card) * 600.0
    wh = torch.rand(n, k, 2, generator=g, device=card) * 120.0 + 4.0
    boxes = torch.cat([xy, xy + wh], -1)
    if edge and k >= 4:
        boxes[:, :4] = torch.tensor([[0, 0, 1, 9], [0, 0, 1, 20], [5, 5, 6, 14], [5, 5, 6, 25]],
                                    dtype=torch.float32, device=card)
    if classes:
        cls = torch.randint(0, classes, (n, k), generator=g, device=card)
        lo = boxes.min()
        offset = torch.clamp_min(boxes.max() - lo, 8192.0) + 1.0
        boxes = (boxes - lo) + (cls.to(boxes.dtype) * offset)[..., None]
    if nan:
        boxes[:, k // 2, 1] = float("nan")
    valid = torch.rand(n, k, generator=g, device=card) < valid_p
    return boxes.contiguous(), valid


@pytest.mark.parametrize("n,k,valid_p,classes,nan,edge", [
    (32, 512, 0.9, 0, False, False),  # the main path's shape
    (32, 512, 0.9, 80, False, True),  # class-aware, a threshold edge
    (32, 512, 1.0, 0, True, False),   # all valid, a NaN box
    (32, 512, 0.0, 0, False, False),  # none valid
    (3, 1, 1.0, 0, False, False), (4, 33, 0.8, 3, False, True),
    (8, 1024, 0.9, 0, True, True),    # the largest K staged in shared memory
    (4, 1025, 0.9, 5, False, False),  # the words in the scratch buffer
    (2, 4099, 0.9, 0, True, False),
    (2, 8400, 0.95, 80, False, True),  # every anchor of a 640 input as a candidate
])
def test_nms_keep_boxes_bit_equal_to_plain(card, n, k, valid_p, classes, nan, edge):
    boxes, valid = _nms_boxes(card, n, k, valid_p, seed=n + k, classes=classes, nan=nan,
                              edge=edge)
    for thr in (0.45, 0.3):
        before = _cuda.LAUNCHES.snapshot()["nms_keep"]
        got = nms_keep_boxes(boxes, valid, thr)
        assert _cuda.LAUNCHES.snapshot()["nms_keep"] == before + 1
        want = nms_keep_boxes_plain(boxes, valid, thr)
        assert torch.equal(got, want), f"K={k} thr={thr}: {(got != want).sum().item()} differ"
        if nan:  # the NaN box overlaps nothing: kept where valid
            assert torch.equal(got[:, k // 2], valid[:, k // 2])
        if edge and not classes and thr == 0.45:  # rank 1's IoU with rank 0 is f32(0.45)
            assert torch.equal(got[:, 1], valid[:, 1])


@pytest.mark.parametrize("n,k,budget_images", [(8, 1025, 3), (5, 33, 2), (32, 8400, None)])
def test_nms_keep_boxes_in_chunks_of_images(card, monkeypatch, n, k, budget_images):
    """A batch whose words exceed the scratch budget runs chunk by chunk
    (N = 32 at K = 8400: two chunks of 16 under the default budget),
    held against the plain version four images at a time."""
    if budget_images:
        monkeypatch.setattr(nms_mod, "SCRATCH_BYTES", budget_images * 4 * mask_words(k))
        assert scratch_chunk(n, k) < n
    else:
        assert scratch_chunk(n, k) == 16
    boxes, valid = _nms_boxes(card, n, k, 0.95, seed=k, classes=80)
    got = nms_keep_boxes(boxes, valid, 0.45)
    for i in range(0, n, 4):
        assert torch.equal(got[i:i + 4], nms_keep_boxes_plain(boxes[i:i + 4], valid[i:i + 4], 0.45))


def test_nms_keep_boxes_builds_no_k_by_k_tensor(card):
    """``batched_nms`` at N = 32, K = 8400 on the card: its peak memory
    stays far under one [N, K, K] bool (2.26 GB)."""
    g = torch.Generator(device=card).manual_seed(5)
    n, m = 32, 8400
    xy = torch.rand(n, m, 2, generator=g, device=card) * 600.0
    boxes = torch.cat([xy, xy + torch.rand(n, m, 2, generator=g, device=card) * 60 + 4], -1)
    scores = torch.rand(n, m, generator=g, device=card)
    cls = torch.randint(0, 80, (n, m), generator=g, device=card, dtype=torch.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    batched_nms(boxes, scores, cls, iou_threshold=0.45, pre_topk=m, class_agnostic=False)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < 100e6


def test_nms_keep_boxes_rejects_what_it_does_not_take(card):
    boxes, valid = _nms_boxes(card, 2, 64, 0.9, seed=1)
    before = _cuda.LAUNCHES.snapshot()["nms_keep"]
    with pytest.raises(ValueError):  # a CPU tensor beside a CUDA one
        nms_keep_boxes(boxes, valid.cpu(), 0.45)
    with pytest.raises(TypeError):
        nms_keep_boxes(boxes.double(), valid, 0.45)
    with pytest.raises(TypeError):
        nms_keep_boxes(boxes, valid.to(torch.uint8), 0.45)
    with pytest.raises(ValueError):
        nms_keep_boxes(boxes[:, :, :3], valid, 0.45)
    with pytest.raises(ValueError):
        nms_keep_boxes(boxes[:, :32], valid, 0.45)
    with pytest.raises(ValueError):
        nms_keep_boxes(boxes.transpose(0, 1).contiguous().transpose(0, 1), valid, 0.45)
    assert _cuda.LAUNCHES.snapshot()["nms_keep"] == before


def _launches_of(name, fn):
    before = _cuda.LAUNCHES.snapshot()[name]
    out = fn()
    assert _cuda.LAUNCHES.snapshot()[name] == before + 1
    return out


def test_each_op_equals_its_wrapper_on_the_card(card):
    g = torch.Generator(device=card).manual_seed(3)
    payload = torch.randn(4, 1000, 4, generator=g, device=card)
    idx = torch.randint(0, 1000, (4, 64), generator=g, device=card)
    assert torch.equal(_launches_of("row_gather", lambda: torch.ops.rva.row_gather(payload, idx)),
                       row_gather(payload, idx))
    levels = [(torch.randn(2, h, h, 64, generator=g, device=card).to(torch.bfloat16),
               torch.randn(2, h, h, 80, generator=g, device=card).to(torch.bfloat16))
              for h in (16, 8, 4)]
    got = _launches_of("decode_v8", lambda: torch.ops.rva.decode_v8_levels(
        [b for b, _ in levels], [c for _, c in levels], [8.0, 16.0, 32.0]))
    for a, b in zip(got, decode_v8_levels(levels, [8.0, 16.0, 32.0])):
        assert torch.equal(a, b)
    sw = prepare_stem(torch.randn(16, 3, 3, 3, generator=g, device=card) * 0.2,
                      torch.randn(16, generator=g, device=card) * 0.1,
                      torch.randn(32, 16, 3, 3, generator=g, device=card) * 0.1,
                      torch.randn(32, generator=g, device=card) * 0.1, torch.bfloat16)
    x = (torch.rand(2, 64, 64, 3, generator=g, device=card) * 255).to(torch.bfloat16)
    got = _launches_of("fused_stem", lambda: torch.ops.rva.fused_stem_p1p2(
        x, sw.w0, sw.b0, sw.w1, sw.b1, sw.w0p, sw.w1p))
    assert torch.equal(got, fused_stem_p1p2(x, sw))
    frames = torch.randint(0, 256, (2, 120, 160, 3), generator=g, device=card,
                           dtype=torch.uint8)
    spec = letterbox_spec((120, 160), (64, 64))
    ops = letterbox_operands(spec, torch.bfloat16, card)
    got = _launches_of("letterbox", lambda: torch.ops.rva.letterbox(
        frames, ops.taps, ops.weights, ops.spans, list(ops.ints), torch.bfloat16))
    assert torch.equal(got, letterbox(frames, spec))
    ov, valid = _overlaps(card, 4, 128, 0.05, 0.9, seed=2)
    got = _launches_of("nms_keep", lambda: torch.ops.rva.nms_keep(ov, valid))
    assert torch.equal(got, nms_keep(ov, valid))
    boxes, valid = _nms_boxes(card, 4, 200, 0.9, seed=3, classes=3)
    got = _launches_of("nms_keep",
                       lambda: torch.ops.rva.nms_keep_boxes(boxes, valid, 0.45))
    assert torch.equal(got, nms_keep_boxes(boxes, valid, 0.45))


# B8: every distinct block of MViTv2-S as (heads, q grid, k/v grid), and one
# small odd shape (Nq and Nk far from a tile's multiple, three heads)
B8_SHAPES = sorted({(s.heads, s.q_thw, s.kv_thw) for s in MViTSpec().blocks()})
B8_ODD = (3, (2, 3, 5), (1, 2, 3))


def _b8_inputs(card, b, heads, q_thw, kv_thw, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    nq, nk = 1 + math.prod(q_thw), 1 + math.prod(kv_thw)

    def bf(*shape):
        return torch.randn(*shape, generator=g, device=card).to(torch.bfloat16)

    return (bf(b, heads, nq, 96), bf(b, heads, nk, 96), bf(b, heads, nk, 96),
            bf(b, heads, nq - 1, kv_thw[0]), bf(b, heads, nq - 1, kv_thw[1]),
            bf(b, heads, nq - 1, kv_thw[2]))


@pytest.mark.parametrize("shape", [*B8_SHAPES, B8_ODD])
@pytest.mark.parametrize("b", [1, 32])
def test_rel_pos_attention_matches_plain(card, b, shape):
    heads, q_thw, kv_thw = shape
    ops = _b8_inputs(card, b, heads, q_thw, kv_thw, seed=b + heads)
    scale = 96 ** -0.5
    got = _launches_of("rel_pos_attention", lambda: rel_pos_attention(*ops, scale))
    want = rel_pos_attention_plain(*(t.float() for t in ops), scale)
    assert got.shape == want.shape == (b, ops[0].shape[2], heads * 96)
    err = (got.float() - want).abs()
    assert err.max().item() <= 0.02 + 0.01 * want.abs().max().item(), err.max().item()
    assert err.mean().item() <= 2e-3
    # the cls row (no bias, no residual) and the last row, past a tile's multiple
    assert torch.allclose(got[:, 0].float(), want[:, 0], atol=0.02)
    assert torch.allclose(got[:, -1].float(), want[:, -1], atol=0.02 + 0.01 * 4)


def test_rel_pos_attention_op_equals_its_wrapper(card):
    ops = _b8_inputs(card, 2, *B8_ODD, seed=11)
    got = _launches_of("rel_pos_attention",
                       lambda: torch.ops.rva.rel_pos_attention(*ops, 96 ** -0.5))
    assert torch.equal(got, rel_pos_attention(*ops, 96 ** -0.5))


def test_rel_pos_attention_rejects_what_it_does_not_take(card):
    ops = _b8_inputs(card, 2, *B8_ODD, seed=12)
    with pytest.raises(TypeError):
        rel_pos_attention(ops[0].float(), *ops[1:], 0.1)
    with pytest.raises(ValueError):  # head dim 64
        rel_pos_attention(*(t[..., :64] if i < 3 else t for i, t in enumerate(ops)), 0.1)
    with pytest.raises(ValueError):  # a table that does not match the k/v grid
        rel_pos_attention(*ops[:5], ops[5][..., :2], 0.1)


def test_mvit_forward_against_the_reference(card):
    """The published MViTv2-S in bf16 on the card (B8 in every block) against
    the plain fp32 reference on two seeded clips, held to the benchmark
    cell's limits."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import plain_mvit

    from realtime_analytics_tpu_torch.models import weights
    from realtime_analytics_tpu_torch.models.mvit import MViT, fused_attentions

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "benchmark", "configs", "mvitv2-s-16x4-224-bf16.json")) as f:
        config = json.load(f)
    sd = weights.mvit_seeded_state_dict(MViTSpec(), seed=5)
    model = MViT(MViTSpec())
    weights.temporal_params_from_jax(model, weights.mvit_params_from_state_dict(model, sd))
    model.to(card, torch.bfloat16).eval()
    clips = torch.randint(0, 256, (2, 16, 224, 224, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(5))
    ref = plain_mvit.MViT(config, sd, device=card)
    want = plain_mvit.logits(ref, clips)
    x = plain_mvit.preprocess(clips).permute(0, 2, 3, 4, 1).contiguous()
    with torch.inference_mode():
        got = model(x.to(card, torch.bfloat16)).cpu()
    assert fused_attentions(model) == 16
    diff = (got - want).abs()
    scale = want.std(dim=1, keepdim=True)
    limits = config["limits"]
    assert (100 * diff.amax(dim=1) / scale[:, 0]).max().item() <= limits["logit_err"]
    assert (100 * diff.pow(2).mean(dim=1).sqrt() / scale[:, 0]).max().item() <= limits["logit_rms"]
