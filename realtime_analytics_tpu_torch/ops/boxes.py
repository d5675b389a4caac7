"""Box geometry ops on torch tensors (shape-polymorphic over leading dims).

Counterpart of ``realtime_analytics_tpu/ops/boxes.py``, with the same
semantics as the reference's NumPy implementations:
  * IoU with union clamped at 1e-6       — reference detector.py:469-481
  * un-letterbox + clip to [0, size-1]   — reference detector.py:340-350
"""

from __future__ import annotations

import torch


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between two box sets: a [..., M, 4], b [..., N, 4]
    (xyxy) -> [..., M, N]. The operations and their order follow the JAX
    version, so fp32 inputs give the same bits."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = (br - tl).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    da = a[..., 2:4] - a[..., :2]
    db = b[..., 2:4] - b[..., :2]
    area_a = da[..., 0] * da[..., 1]
    area_b = db[..., 0] * db[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union.clamp_min(1e-6)


def unletterbox_boxes(
    boxes: torch.Tensor,
    scale: float,
    pad_left: int,
    pad_top: int,
    orig_h: int,
    orig_w: int,
) -> torch.Tensor:
    """Map xyxy boxes [..., D, 4] from letterboxed input pixels back to
    original-frame pixels and clip to the frame. The geometry is static (the
    engine prepares one step per source resolution: ``engine/graphs.py``)
    and enters as Python numbers, so no host tensor is copied to the card
    and a captured step holds no host wait. fp32 boxes give the JAX
    version's bits: the same subtraction, division and clip, in its order."""
    x = ((boxes[..., 0::2] - pad_left) / float(scale)).clamp(0.0, orig_w - 1.0)
    y = ((boxes[..., 1::2] - pad_top) / float(scale)).clamp(0.0, orig_h - 1.0)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)
