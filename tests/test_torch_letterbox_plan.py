"""Kernel B4's block plan on the CPU.

csrc/letterbox.cu runs only on the card (tests/test_torch_kernels_cuda.py).
What it is handed is built in Python (``ops/letterbox.py``:
``letterbox_instantiation``, ``letterbox_plan``, ``segment_spans``) and is
held here: the instantiation picker; the plan's alignment and shared-memory
rules; and a replay of the kernel, segment by segment, in numpy: what a
block stages of its source rows (its span, or nothing where it reads the
taps in place), that every tap of nonzero weight reads a staged byte or a
byte of its row, and that leaving out the taps of weight 0 gives
``letterbox_plain``'s output bit for bit, at the six geometries ``chip_smoke.py`` times and at odd ones.
"""

import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.ops.letterbox import (
    MAX_SEG_W,
    SMEM_LIMIT,
    bilinear_taps,
    letterbox_instantiation,
    letterbox_plain,
    letterbox_plan,
    segment_spans,
    stretch_spec,
)
from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec

# name -> (source H, W), (canvas H, W), stretch
GEOMETRIES = {
    "select": ((1080, 1920), (640, 640), False),     # chip_smoke.py's six
    "mean2": ((720, 1280), (640, 640), False),
    "matmul": ((1520, 2688), (640, 640), False),
    "stretch": ((1080, 1920), (224, 224), True),
    "clip_112": ((1080, 1920), (112, 112), True),
    "odd_211": ((97, 211), (128, 128), False),       # 3 * 211 % 16 != 0
    "odd_131": ((75, 131), (128, 128), False),       # upscale, pad on both axes
    "upscale": ((48, 40), (64, 64), True),           # neighbours share taps
    "tall": ((500, 300), (128, 128), False),         # pad columns left and right
    "wide_out": ((16, 4096), (4, 2000), True),       # two segments a row
    "odd_out": ((90, 160), (33, 50), True),          # output rows off 16 bytes
}


def _spec(name):
    src, dst, stretch = GEOMETRIES[name]
    return stretch_spec(src, dst) if stretch else letterbox_spec(src, dst)


def _kind(spec, dtype):
    return letterbox_instantiation(spec.src_w, spec.dst_w, dtype, True)


@pytest.mark.parametrize("src_w,dst_w,dtype,aligned,want", [
    (1920, 640, torch.bfloat16, True, "vec16"),   # 5760-byte rows
    (1280, 640, torch.bfloat16, True, "vec16"),
    (2688, 640, torch.bfloat16, True, "vec16"),
    (1920, 224, torch.float32, True, "vec16"),
    (1920, 112, torch.float32, True, "vec16"),
    (1920, 640, torch.bfloat16, False, "element"),  # frames off a 16-byte line
    (211, 128, torch.bfloat16, True, "element"),    # 633-byte rows
    (131, 128, torch.float32, True, "element"),
    (160, 50, torch.bfloat16, True, "element"),     # 300-byte output rows
    (160, 50, torch.float32, True, "element"),      # 600-byte output rows
    (160, 52, torch.float32, True, "vec16"),        # 624 = 39 * 16
    (1920, 640, torch.float16, True, None),
    (1920, 640, torch.uint8, True, None),
])
def test_letterbox_instantiation(src_w, dst_w, dtype, aligned, want):
    assert letterbox_instantiation(src_w, dst_w, dtype, aligned) == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("name", GEOMETRIES)
def test_plan_rules(name, dtype):
    spec = _spec(name)
    kind = _kind(spec, dtype)
    plan = letterbox_plan(spec, dtype, kind)
    esz = 2 if dtype == torch.bfloat16 else 4
    segments = -(-spec.dst_w // plan.seg_w)
    assert plan.kind == kind and plan.spans.shape == (segments, 2)
    assert plan.spans.dtype == np.int32
    assert plan.seg_w <= MAX_SEG_W and plan.span_cap % 16 == 0
    strip = -(-plan.seg_w * 3 * esz // 16) * 16
    assert plan.smem_bytes == (2 * plan.span_cap + strip if plan.dense else 0)
    assert plan.smem_bytes <= SMEM_LIMIT and plan.threads in (128, 256)
    start, size = plan.spans[:, 0], plan.spans[:, 1]
    assert (start >= 0).all() and (start + size <= 3 * spec.src_w).all()
    assert plan.span_cap == (-(-size.max() // 16) * 16 if plan.dense else 0)
    if kind == "vec16":  # cp.async and the stores move whole 16-byte units
        assert (start % 16 == 0).all() and (size % 16 == 0).all()
        assert (3 * spec.src_w) % 16 == 0
        assert segments == 1 or (plan.seg_w * 3 * esz) % 16 == 0
        assert (spec.dst_w * 3 * esz) % 16 == 0
    # only the 224- and 112-wide stretches spread their taps beyond 16 bytes a pixel
    assert plan.dense == (name not in ("stretch", "clip_112"))


def test_plan_cuts_wide_rows_and_refuses_what_cannot_fit(monkeypatch):
    plan = letterbox_plan(_spec("wide_out"), torch.float32, "vec16")
    assert plan.seg_w == 1000 and len(plan.spans) == 2
    spec = stretch_spec((1, 400_000), (1, 8))  # 8 pixels whose taps span a megabyte
    far = letterbox_plan(spec, torch.float32, "vec16")
    assert not far.dense and far.span_cap == 0 and far.smem_bytes == 0
    # staged all the same, that span would not fit a block: refused, not cut short
    monkeypatch.setattr("realtime_analytics_tpu_torch.ops.letterbox.DENSE_SRC_BYTES", 10**6)
    with pytest.raises(ValueError, match="shared memory"):
        letterbox_plan(spec, torch.float32, "vec16")


def _replay(frames, spec, plan, dense):
    """csrc/letterbox.cu on its plan, in numpy: per segment, what the block
    stages (``dense``: its span; else nothing, the taps are read in place)
    and, from staged bytes or bytes of the row only, the fp32 output before
    the cast."""
    nh, nw = spec.new_h, spec.new_w
    y0, y1, wy = bilinear_taps(spec.src_h, nh)
    x0, x1, wx = bilinear_taps(spec.src_w, nw)
    rows = frames.reshape(len(frames), spec.src_h, spec.src_w * 3).astype(np.float32)
    one = np.float32(1.0)
    pad = np.float32(114.0) * (one / np.float32(255.0))
    out = np.full((len(frames), spec.dst_h, spec.dst_w, 3), pad, np.float32)
    for seg, (start, size) in enumerate(plan.spans):
        sx = seg * plan.seg_w
        length = min(plan.seg_w, spec.dst_w - sx)
        c_lo, c_hi = max(sx - spec.pad_left, 0), min(sx + length - spec.pad_left, nw)
        if c_lo >= c_hi:
            assert size == 0
            continue
        cols = np.arange(c_lo, c_hi)
        if not dense:
            start = 0
        # byte b of a staged row is byte start + b of the source row; in
        # place, every byte of the row is there to read
        readable = np.zeros(3 * spec.src_w - start, bool)
        readable[:size if dense else None] = True
        assert not dense or size <= plan.span_cap
        a = 3 * x0[cols] - start
        b = 3 * x1[cols] - start
        second = wx[cols] != 0
        assert (a >= 0).all()
        for ch in range(3):  # every byte read is there
            assert readable[a + ch].all() and readable[b[second] + ch].all()
        # H pass (a second row only where wy != 0), then W pass (a second
        # column only where wx != 0), all in fp32 without FMA
        two_rows = (wy != 0)[None, :, None]
        wy_, wx_ = wy[None, :, None], wx[cols][None, None, :, None]
        r0, r1 = rows[:, y0], rows[:, y1]
        h = np.where(two_rows, (one - wy_) * r0 + wy_ * r1, r0)
        h = h.reshape(len(frames), nh, spec.src_w, 3)
        ha, hb = h[:, :, x0[cols]], h[:, :, x1[cols]]
        r = np.where(wx_ != 0, (one - wx_) * ha + wx_ * hb, ha)
        r = np.clip(np.floor(r + np.float32(0.5)), 0, 255) * (one / np.float32(255.0))
        out[:, spec.pad_top:spec.pad_top + nh,
            spec.pad_left + c_lo:spec.pad_left + c_hi] = r[..., ::-1]
    return out


@pytest.mark.parametrize("dense", [None, False], ids=["planned", "in_place"])
@pytest.mark.parametrize("name", GEOMETRIES)
def test_replay_is_bit_equal_to_plain(name, dense):
    spec = _spec(name)
    frames = np.random.default_rng(11).integers(
        0, 256, (1, spec.src_h, spec.src_w, 3), dtype=np.uint8)
    plan = letterbox_plan(spec, torch.bfloat16, _kind(spec, torch.bfloat16))
    got = _replay(frames, spec, plan, plan.dense if dense is None else dense)
    want = letterbox_plain(torch.from_numpy(frames), spec, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["select", "mean2", "matmul", "stretch", "clip_112",
                                  "upscale"])
def test_spans_hold_exactly_the_tapped_bytes(name):
    """A segment's span starts at its first tap and ends at its last one
    of nonzero weight (to the unit): nothing tapped is left out, and at an
    integer ratio the never-read second tap is not staged for."""
    spec = _spec(name)
    x0, x1, wx = bilinear_taps(spec.src_w, spec.new_w)
    for unit in (1, 16):
        (start, size), = segment_spans(spec, spec.dst_w, unit)
        last = np.where(wx > 0, x1, x0).max()
        assert start == 3 * x0.min() // unit * unit
        assert start + size == -(-(3 * last + 3) // unit) * unit
    if name == "select":  # 1920 -> 640: taps 3 i + 1 of weight 1, the second never read
        assert (wx == 0).all() and (bilinear_taps(1080, 360)[2] == 0).all()
        assert segment_spans(spec, 640, 1).tolist() == [[3, 3 * 1918 + 3 - 3]]
