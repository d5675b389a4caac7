"""Batched fixed-shape NMS in PyTorch.

Counterpart of ``realtime_analytics_tpu/ops/nms.py::batched_nms``, keeping
every rule of the reference (``ops/nms.py:74-191``), for the whole batch at
once:

  1. top-K candidates (K = ``pre_topk``) by a STABLE descending sort, so
     tied scores go to the lowest index (``torch.topk`` promises no order
     among ties; ``jax.lax.top_k`` takes the lowest index first);
  2. one IoU matrix per image [K, K]; suppression is strict, ``iou > thr``;
  3. greedy suppression as the monotone fixpoint ``keep = valid & ~(overlap
     @ keep > 0)``, swept until nothing changes (equal to greedy NMS). Each
     sweep is one batched matmul and one host sync to test for change;
  4. kept rows compacted by a stable argsort of ``~keep`` into ``max_det``
     padded slots, plus a validity count.

For class-aware NMS the boxes are shifted per class by an offset taken from
the GLOBAL min/max over the whole [N, K, 4] candidate tensor — a quirk of
the reference that the port matches. Both payload gathers (top-K boxes and
the compaction payload) go through kernel B1 (``ops/gather.py``) unless
``gather_impl="torch"``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .boxes import iou_matrix
from .gather import row_gather

_CLASS_OFFSET = 8192.0  # class-shift floor (actual offset adapts to coords)


def _torch_gather(payload: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(payload, 1, idx[..., None].expand(-1, -1, payload.shape[-1]))


def batched_nms(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    class_ids: torch.Tensor,
    *,
    iou_threshold: float,
    max_det: int = 300,
    pre_topk: int = 1024,
    class_agnostic: bool = True,
    gather_impl: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched NMS with static output shapes.

    Args:
      boxes:     [N, M, 4] xyxy (any pixel space).
      scores:    [N, M] confidence; entries below the confidence threshold
                 must already be zeroed (0 == invalid candidate).
      class_ids: [N, M] integer class ids.
      gather_impl: "kernel" — payload gathers through B1 (the CUDA kernel on
                 the card, its plain version on the CPU) — or "torch"
                 (``torch.gather``). Results are bit-identical.

    Returns:
      (boxes [N, max_det, 4] f32, scores [N, max_det] f32,
       class_ids [N, max_det] int32, num_valid [N] int32) — rows past
      num_valid[i] are zero padding.
    """
    if gather_impl not in ("kernel", "torch"):
        raise ValueError(f"gather_impl must be 'kernel' or 'torch', got {gather_impl!r}")
    gather = row_gather if gather_impl == "kernel" else _torch_gather
    n, m = scores.shape
    k = min(pre_topk, m)
    dev = scores.device

    # 1. top-K, score-descending, ties to the lowest index
    sorted_scores, order = torch.sort(scores, dim=1, descending=True, stable=True)
    top_scores = sorted_scores[:, :k].contiguous()
    top_idx = order[:, :k].contiguous()
    top_boxes = gather(boxes.to(torch.float32).contiguous(), top_idx)  # [N, K, 4]
    top_classes = torch.gather(class_ids, 1, top_idx).to(torch.int32)
    valid = top_scores > 0.0

    # 2. overlap matrix (class-aware: shift classes into disjoint bands)
    nms_boxes = top_boxes
    if not class_agnostic:
        lo = top_boxes.min()
        offset = torch.clamp_min(top_boxes.max() - lo, _CLASS_OFFSET) + 1.0
        nms_boxes = (top_boxes - lo) + (
            top_classes.to(top_boxes.dtype) * offset
        )[..., None]
    iou = iou_matrix(nms_boxes, nms_boxes)  # [N, K, K]
    rank = torch.arange(k, device=dev)
    outranked = rank[None, :, None] > rank[None, None, :]  # j before i
    overlap = (
        (iou > iou_threshold) & outranked & valid[:, None, :] & valid[:, :, None]
    ).to(torch.float32)

    # 3. fixpoint sweeps (0/1 sums in fp32 are exact)
    keep = valid
    for _ in range(k):
        suppressed = torch.bmm(overlap, keep.to(torch.float32)[..., None])[..., 0] > 0.0
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep

    # 4. stable compaction, kept rows first in score order
    d = min(max_det, k)
    order_d = torch.argsort((~keep).to(torch.uint8), dim=-1, stable=True)[:, :d]
    payload = torch.cat(
        [top_boxes, top_scores[..., None], top_classes.to(torch.float32)[..., None]],
        dim=-1,
    )  # [N, K, 6]
    g = gather(payload, order_d.contiguous())
    num_kept = torch.clamp_max(keep.sum(dim=-1), d).to(torch.int32)
    slot_valid = torch.arange(d, device=dev)[None, :] < num_kept[:, None]
    out_boxes = torch.where(slot_valid[..., None], g[..., :4], 0.0)
    out_scores = torch.where(slot_valid, g[..., 4], 0.0)
    out_classes = torch.where(slot_valid, g[..., 5].to(torch.int32), 0)
    if d < max_det:  # pad up to the static contract
        pad = max_det - d
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        out_scores = torch.nn.functional.pad(out_scores, (0, pad))
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
    return out_boxes, out_scores, out_classes, num_kept
