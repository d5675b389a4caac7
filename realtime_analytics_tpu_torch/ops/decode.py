"""B2: fused YOLOv8 head decode of one level (DFL + class reduce).

Counterpart of ``realtime_analytics_tpu/ops/pallas_decode.py`` (Pallas
``_decode_kernel``). On the card ``decode_v8_level`` launches the
hand-written kernel of ``csrc/decode.cu`` (one thread per anchor, logits
read once, fp32 math). ``decode_v8_level_plain`` is the num/den DFL form of
the reference's plain decode (``models/yolo.py:483-505``) in PyTorch;
``decode_v8_level`` takes it only for tensors on the CPU.

Inputs are NHWC: ``box_f`` [N, h, w, 64] DFL logits and ``cls_f``
[N, h, w, nc] class logits, bf16 or fp32. The model passes the head's last
1x1 conv output, a ``channels_last`` NCHW tensor, as ``permute(0, 2, 3, 1)``
— which IS [N, h, w, C]-contiguous, so no copy is made. The kernel wrapper
raises on a non-contiguous input rather than copying silently.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda

REG_MAX = 16

_launch = None  # the bound C entry, set at the first launch


def decode_v8_level_plain(
    box_f: torch.Tensor, cls_f: torch.Tensor, *, stride: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode: (boxes [N, h*w, 4] f32 xyxy input-px,
    conf [N, h*w] f32, cls [N, h*w] int32)."""
    n, h, w, _ = box_f.shape
    dev = box_f.device
    xd = box_f.to(torch.float32).reshape(n, h, w, 4, REG_MAX)
    mx = xd.amax(dim=-1, keepdim=True)
    e = torch.exp(xd - mx)
    proj = torch.arange(REG_MAX, dtype=torch.float32, device=dev)
    dist = (e * proj).sum(dim=-1) / e.sum(dim=-1)  # (l, t, r, b)
    ax = torch.arange(w, dtype=torch.float32, device=dev) + 0.5
    ay = torch.arange(h, dtype=torch.float32, device=dev) + 0.5
    gy, gx = torch.meshgrid(ay, ax, indexing="ij")  # [h, w]
    x1 = (gx - dist[..., 0]) * stride
    y1 = (gy - dist[..., 1]) * stride
    x2 = (gx + dist[..., 2]) * stride
    y2 = (gy + dist[..., 3]) * stride
    boxes = torch.stack([x1, y1, x2, y2], dim=-1).reshape(n, h * w, 4)
    # max/argmax on the raw logits (sigmoid is monotonic); argmax returns
    # the first maximal index, like jnp.argmax
    conf = torch.sigmoid(cls_f.amax(dim=-1).to(torch.float32)).reshape(n, h * w)
    cls = cls_f.argmax(dim=-1).to(torch.int32).reshape(n, h * w)
    return boxes, conf, cls


def decode_v8_level(
    box_f: torch.Tensor, cls_f: torch.Tensor, *, stride: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Decode one v8 head level; same contract as the plain version."""
    global _launch
    if box_f.device.type == "cpu" and cls_f.device.type == "cpu":
        return decode_v8_level_plain(box_f, cls_f, stride=stride)
    dev = _cuda.require_cuda("decode_v8_level", box_f, cls_f)
    if box_f.dtype != cls_f.dtype or box_f.dtype not in (
        torch.bfloat16, torch.float32
    ):
        raise TypeError(
            "decode_v8_level: box_f and cls_f must both be bf16 or both "
            f"fp32, got {box_f.dtype} and {cls_f.dtype}"
        )
    if box_f.dim() != 4 or box_f.shape[-1] != 4 * REG_MAX or (
        cls_f.dim() != 4 or cls_f.shape[:3] != box_f.shape[:3]
    ):
        raise ValueError(
            "decode_v8_level: need box_f [N, h, w, 64] and cls_f "
            f"[N, h, w, nc], got {tuple(box_f.shape)} and {tuple(cls_f.shape)}"
        )
    if not (box_f.is_contiguous() and cls_f.is_contiguous()):
        raise ValueError(
            "decode_v8_level: inputs must be [N, h, w, C]-contiguous (a "
            "channels_last conv output viewed with permute(0, 2, 3, 1))"
        )
    n, h, w, _ = box_f.shape
    nc = cls_f.shape[-1]
    boxes = torch.empty((n, h * w, 4), dtype=torch.float32, device=dev)
    conf = torch.empty((n, h * w), dtype=torch.float32, device=dev)
    cls = torch.empty((n, h * w), dtype=torch.int32, device=dev)
    if _launch is None:
        _launch = _cuda.entry("rva_decode_v8")
    rc = _launch(
        dev.index, box_f.data_ptr(), cls_f.data_ptr(), boxes.data_ptr(),
        conf.data_ptr(), cls.data_ptr(), n, h, w, nc, float(stride),
        int(box_f.dtype == torch.bfloat16), _cuda.stream_of(dev.index),
    )
    if rc:
        _cuda.fail(rc, "decode_v8_level")
    _cuda.LAUNCHES.add("decode_v8")
    return boxes, conf, cls
