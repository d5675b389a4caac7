"""Batched letterbox preprocessing in plain PyTorch.

Counterpart of ``realtime_analytics_tpu/ops/preprocess.py``. The letterbox
geometry (scale, resized size, pad split) is static per (source HxW ->
target HxW) pair and matches the reference bit-for-bit:

    scale = min(tw/w, th/h); new = int(round-toward-zero(size * scale))
    pad_top = (th - new_h) // 2 ; pad_left = (tw - new_w) // 2

``preprocess_batch`` is plain tensor code in the JAX package too (XLA, not
a Pallas kernel); its Pallas sibling ``pallas_letterbox`` (kernel B4) is
not ported yet (ROADMAP.md). ``letterbox_numpy`` is the host/cv2 oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

PAD_VALUE = 114.0


@dataclass(frozen=True)
class LetterboxSpec:
    """Static letterbox geometry for one (src -> dst) resolution pair."""

    src_h: int
    src_w: int
    dst_h: int
    dst_w: int
    scale: float
    new_h: int
    new_w: int
    pad_top: int
    pad_left: int


def letterbox_spec(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> LetterboxSpec:
    h, w = src_hw
    th, tw = dst_hw
    scale = min(tw / w, th / h)
    new_w = int(w * scale)
    new_h = int(h * scale)
    return LetterboxSpec(
        src_h=h,
        src_w=w,
        dst_h=th,
        dst_w=tw,
        scale=scale,
        new_h=new_h,
        new_w=new_w,
        pad_top=(th - new_h) // 2,
        pad_left=(tw - new_w) // 2,
    )


def integer_axis_reduction(src: int, dst: int):
    """How half-pixel-center bilinear degenerates for an exact integer
    downscale ratio r = src/dst (source coords are (i+0.5)·r − 0.5):

      * ``("select", r, off)`` — r odd: coords are INTEGRAL, the resize is
        an exact pixel pick at stride r, offset (r−1)/2;
      * ``("mean2", r, off)`` — r even: coords land exactly halfway, a
        2-tap mean of offsets off, off+1 at stride r;
      * ``None`` — fractional ratio (general bilinear needed).

    The geometry invariant shared by the host pixel-pick upload (engine
    host_select) and the fast paths below.
    """
    if src != dst and src % dst == 0:
        r = src // dst
        if r % 2 == 1:
            return ("select", r, (r - 1) // 2)
        return ("mean2", r, r // 2 - 1)
    return None


def _take(x: torch.Tensor, axis: int, start: int, stop: int, step: int):
    index = [slice(None)] * x.dim()
    index[axis] = slice(start, stop, step)
    return x[tuple(index)]


def _resize_axis(x: torch.Tensor, axis: int, src: int, dst: int) -> torch.Tensor:
    """Bilinear (half-pixel centers, no antialias) resize of an NHWC tensor
    along axis 1 (H) or 2 (W), with the ``integer_axis_reduction`` fast
    paths; fractional ratios take ``F.interpolate`` (bilinear,
    align_corners=False), whose edge clamping equals jax.image.resize's
    edge renormalisation for a 2-tap kernel."""
    if dst == src:
        return x
    red = integer_axis_reduction(src, dst)
    if red is not None:
        mode, r, off = red
        t1 = _take(x, axis, off, off + r * (dst - 1) + 1, r)
        if mode == "select":
            return t1
        t2 = _take(x, axis, off + 1, off + r * (dst - 1) + 2, r)
        return (t1 + t2) * 0.5
    nchw = x.permute(0, 3, 1, 2)
    size = [nchw.shape[2], nchw.shape[3]]
    size[axis - 1] = dst
    out = F.interpolate(nchw, size=size, mode="bilinear", align_corners=False)
    return out.permute(0, 2, 3, 1)


def preprocess_batch(
    frames: torch.Tensor,
    *,
    spec: LetterboxSpec,
    out_dtype: torch.dtype = torch.bfloat16,
    round_uint8: bool = True,
    layout: str = "NCHW",
) -> torch.Tensor:
    """uint8 NHWC BGR batch -> normalized letterboxed batch.

    Args:
      frames: [N, src_h, src_w, 3] uint8 BGR.
      round_uint8: round the resized image to integers before normalizing,
        matching cv2's uint8 resize output (the reference resizes in uint8).
      layout: "NCHW" (reference tensor layout) or "NHWC".

    Returns [N, 3, dst_h, dst_w] (or NHWC) in ``out_dtype``, RGB in [0, 1].
    """
    needs_resize = (spec.new_h, spec.new_w) != (spec.src_h, spec.src_w)
    int_ratio = (
        needs_resize
        and spec.src_h % spec.new_h == 0
        and spec.src_w % spec.new_w == 0
        and (spec.src_h // spec.new_h) % 2 == 1
        and (spec.src_w // spec.new_w) % 2 == 1
    )
    if int_ratio:
        # odd-integer ratio: a strided pick on the uint8 input, so the
        # full-resolution frame is never materialized in float
        x = _resize_axis(frames, 1, spec.src_h, spec.new_h)
        x = _resize_axis(x, 2, spec.src_w, spec.new_w).to(torch.float32)
    else:
        x = frames.to(torch.float32)
        if needs_resize:
            x = _resize_axis(x, 1, spec.src_h, spec.new_h)
            x = _resize_axis(x, 2, spec.src_w, spec.new_w)
            if round_uint8:
                # floor(x + 0.5): cv2's fixed-point uint8 resize rounds
                # halves UP (torch.round is half-to-even)
                x = torch.floor(x + 0.5).clamp(0.0, 255.0)
    pad_bottom = spec.dst_h - spec.new_h - spec.pad_top
    pad_right = spec.dst_w - spec.new_w - spec.pad_left
    x = F.pad(
        x, (0, 0, spec.pad_left, pad_right, spec.pad_top, pad_bottom),
        value=PAD_VALUE,
    )
    x = x.flip(-1)  # BGR -> RGB
    x = x * (1.0 / 255.0)
    if layout == "NCHW":
        x = x.permute(0, 3, 1, 2).contiguous()
    return x.to(out_dtype)


def letterbox_numpy(
    frame: np.ndarray,
    dst_hw: Tuple[int, int],
    dtype: np.dtype = np.float32,
) -> Tuple[np.ndarray, dict]:
    """Host/cv2 oracle with the reference's exact semantics.

    Returns (tensor [1, 3, H, W] RGB normalized, meta {orig_shape, scale, pad}).
    """
    import cv2

    spec = letterbox_spec(frame.shape[:2], dst_hw)
    if (spec.new_h, spec.new_w) != (spec.src_h, spec.src_w):
        resized = cv2.resize(
            frame, (spec.new_w, spec.new_h), interpolation=cv2.INTER_LINEAR
        )
    else:
        resized = frame
    canvas = cv2.copyMakeBorder(
        resized,
        spec.pad_top,
        spec.dst_h - spec.new_h - spec.pad_top,
        spec.pad_left,
        spec.dst_w - spec.new_w - spec.pad_left,
        cv2.BORDER_CONSTANT,
        value=(114, 114, 114),
    )
    image = cv2.cvtColor(canvas, cv2.COLOR_BGR2RGB).astype(dtype) * (1.0 / 255.0)
    tensor = np.expand_dims(np.ascontiguousarray(image.transpose(2, 0, 1)), 0)
    meta = {
        "orig_shape": (spec.src_h, spec.src_w),
        "scale": spec.scale,
        "pad": (spec.pad_left, spec.pad_top),
    }
    return tensor, meta
