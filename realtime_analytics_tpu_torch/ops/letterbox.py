"""B4: bilinear letterbox / stretch resize of a uint8 BGR batch.

Counterpart of ``realtime_analytics_tpu/ops/pallas_preprocess.py`` (Pallas
``_kernel``, reached from ``pallas_letterbox`` and
``pallas_stretch_resize``). On the card ``letterbox`` and
``stretch_resize`` launch the hand-written kernel of ``csrc/letterbox.cu``:
one thread per output pixel, taps and weights from small per-axis tables
that are built once per geometry and kept on the device.
``letterbox_plain`` and ``stretch_resize_plain`` are the same function in
plain PyTorch on the same tables, in the same order (row gather, H pass,
column gather, W pass), so the two agree bit for bit; the wrappers take
them only for tensors on the CPU. ``preprocess_batch`` computes the same
resize with ``F.interpolate``'s fp32 weights, which can round a value at
an exact .5 level boundary the other way.

The function: uint8 NHWC BGR ``[N, Hs, Ws, 3]`` -> RGB in [0, 1],
``[N, dst_h, dst_w, 3]``, resized with half-pixel-centre edge-clamped
bilinear (H first, then W, in fp32), rounded half up to uint8 levels as cv2
does, and padded with 114/255 outside the content window.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import _cuda
from .preprocess import PAD_VALUE, LetterboxSpec

_TABLES: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}
_launch = None  # the bound C entry, set at the first launch


def bilinear_taps(src: int, dst: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per output index: the two source taps (edge-clamped) and the weight
    of the second — the geometry of the reference's ``bilinear_matrix``:
    source coordinate (i + 0.5) * src / dst - 0.5. Where both taps clamp to
    one pixel the weight is 0, so the pick is exact."""
    x = (np.arange(dst, dtype=np.float64) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x)
    w = x - x0
    i0 = np.clip(x0, 0, src - 1).astype(np.int32)
    i1 = np.clip(x0 + 1, 0, src - 1).astype(np.int32)
    w = np.where(i0 == i1, 0.0, w).astype(np.float32)
    return i0, i1, w


def _tables(spec: LetterboxSpec, device: torch.device):
    """(taps int32 [2*new_h + 2*new_w], weights fp32 [new_h + new_w]) on
    ``device``, in csrc/letterbox.cu's order; built once per geometry."""
    key = (spec.src_h, spec.src_w, spec.new_h, spec.new_w, str(device))
    hit = _TABLES.get(key)
    if hit is None:
        y0, y1, wy = bilinear_taps(spec.src_h, spec.new_h)
        x0, x1, wx = bilinear_taps(spec.src_w, spec.new_w)
        taps = torch.from_numpy(np.concatenate([y0, y1, x0, x1])).to(device)
        weights = torch.from_numpy(np.concatenate([wy, wx])).to(device)
        hit = _TABLES[key] = (taps, weights)
    return hit


def stretch_spec(src_hw: Tuple[int, int], dst_hw: Tuple[int, int]) -> LetterboxSpec:
    """The zero-pad spec of a non-aspect-preserving resize, as
    ``pallas_stretch_resize`` builds it."""
    return LetterboxSpec(
        src_h=src_hw[0], src_w=src_hw[1], dst_h=dst_hw[0], dst_w=dst_hw[1],
        scale=1.0, new_h=dst_hw[0], new_w=dst_hw[1], pad_top=0, pad_left=0,
    )


def letterbox_plain(frames_u8: torch.Tensor, spec: LetterboxSpec,
                    out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version, any device: the kernel's tables and fp32
    arithmetic as tensor ops."""
    taps, weights = _tables(spec, frames_u8.device)
    nh, nw = spec.new_h, spec.new_w
    y0, y1 = taps[:nh].long(), taps[nh:2 * nh].long()
    x0, x1 = taps[2 * nh:2 * nh + nw].long(), taps[2 * nh + nw:].long()
    wy, wx = weights[:nh].view(1, nh, 1, 1), weights[nh:].view(1, 1, nw, 1)
    rows0 = frames_u8.index_select(1, y0).to(torch.float32)
    rows1 = frames_u8.index_select(1, y1).to(torch.float32)
    h = (1.0 - wy) * rows0 + wy * rows1  # [N, new_h, src_w, 3]
    r = (1.0 - wx) * h.index_select(2, x0) + wx * h.index_select(2, x1)
    r = torch.floor(r + 0.5).clamp_(0.0, 255.0) * (1.0 / 255.0)
    out = torch.full((frames_u8.shape[0], spec.dst_h, spec.dst_w, 3), PAD_VALUE,
                     dtype=torch.float32, device=frames_u8.device) * (1.0 / 255.0)
    out[:, spec.pad_top:spec.pad_top + nh, spec.pad_left:spec.pad_left + nw] = r.flip(-1)
    return out.to(out_dtype)


def letterbox(frames_u8: torch.Tensor, spec: LetterboxSpec,
              out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """frames_u8: [N, src_h, src_w, 3] uint8 BGR, contiguous. Returns the
    letterboxed RGB canvas [N, dst_h, dst_w, 3] in ``out_dtype`` (bf16 or
    fp32), NHWC-contiguous."""
    global _launch
    if frames_u8.device.type == "cpu":
        return letterbox_plain(frames_u8, spec, out_dtype)
    dev = _cuda.require_cuda("letterbox", frames_u8)
    if frames_u8.dtype != torch.uint8 or out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(
            f"letterbox: need uint8 frames and a bf16 or fp32 output, got "
            f"{frames_u8.dtype} -> {out_dtype}"
        )
    if frames_u8.dim() != 4 or tuple(frames_u8.shape[1:]) != (spec.src_h, spec.src_w, 3):
        raise ValueError(
            f"letterbox: need frames [N, {spec.src_h}, {spec.src_w}, 3], got "
            f"{tuple(frames_u8.shape)}"
        )
    if not frames_u8.is_contiguous():
        raise ValueError("letterbox: frames must be contiguous")
    n = frames_u8.shape[0]
    taps, weights = _tables(spec, dev)
    out = torch.empty((n, spec.dst_h, spec.dst_w, 3), dtype=out_dtype, device=dev)
    if _launch is None:
        _launch = _cuda.entry("rva_letterbox")
    rc = _launch(
        dev.index, frames_u8.data_ptr(), out.data_ptr(), taps.data_ptr(),
        weights.data_ptr(), n, spec.src_h, spec.src_w, spec.dst_h, spec.dst_w,
        spec.new_h, spec.new_w, spec.pad_top, spec.pad_left,
        int(out_dtype == torch.bfloat16), _cuda.stream_of(dev.index),
    )
    if rc:
        _cuda.fail(rc, "letterbox")
    _cuda.LAUNCHES.add("letterbox")
    return out


def stretch_resize_plain(frames_u8: torch.Tensor, dst_hw: Tuple[int, int],
                         out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Plain PyTorch version of ``stretch_resize``, any device."""
    spec = stretch_spec(tuple(frames_u8.shape[1:3]), dst_hw)
    return letterbox_plain(frames_u8, spec, out_dtype)


def stretch_resize(frames_u8: torch.Tensor, dst_hw: Tuple[int, int],
                   out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Non-aspect-preserving resize to ``dst_hw`` (the ResNet and temporal
    preprocess): the letterbox kernel with a zero-pad spec."""
    spec = stretch_spec(tuple(frames_u8.shape[1:3]), dst_hw)
    return letterbox(frames_u8, spec, out_dtype)
