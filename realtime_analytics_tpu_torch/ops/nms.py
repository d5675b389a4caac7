"""Batched fixed-shape NMS in PyTorch.

Counterpart of ``realtime_analytics_tpu/ops/nms.py::batched_nms``, keeping
every rule of the reference (``ops/nms.py:74-191``), for the whole batch at
once:

  1. top-K candidates (K = ``pre_topk``) by a STABLE descending sort, so
     tied scores go to the lowest index (``torch.topk`` promises no order
     among ties; ``jax.lax.top_k`` takes the lowest index first);
  2. greedy suppression: candidate i is dropped when a kept better-ranked
     candidate j has ``iou(i, j) > thr`` (strict). The keep mask is the
     unique fixpoint of ``keep = valid & ~(overlap @ keep > 0)`` over the
     [K, K] overlap matrix, which the reference builds and sweeps on
     device. On the card kernel B6 (``csrc/nms.cu``, ``nms_keep_boxes``)
     computes it from the boxes: the IoU bits packed to words across the
     card, then a chain of 32-rank steps, one block an image, with no
     [N, K, K] tensor and no host wait; the plain version
     (``nms_keep_boxes_plain``, what the CPU runs) builds the overlap
     matrix and sweeps it until nothing changes, one batched matmul and
     one host sync a sweep, as the reference's ``lax.while_loop`` sweeps;
  3. kept rows compacted by a stable argsort of ``~keep`` into ``max_det``
     padded slots, plus a validity count.

For class-aware NMS the boxes are shifted per class by an offset taken from
the GLOBAL min/max over the whole [N, K, 4] candidate tensor — a quirk of
the reference that the port matches. Both payload gathers (top-K boxes and
the compaction payload) go through kernel B1 (``ops/gather.py``) unless
``gather_impl="torch"``.

``nms_keep_boxes`` is also the registered op ``rva::nms_keep_boxes``, which
an exported step keeps as one node: the kernel on CUDA tensors, the plain
version on CPU ones. ``nms_keep`` (op ``rva::nms_keep``) takes a ready
overlap matrix instead, as the artifacts of earlier versions of the port
call it; on the card it packs the matrix into B6's words and runs the same
chain. Either entry counts one ``nms_keep`` launch a call.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import _cuda
from .boxes import iou_matrix
from .gather import row_gather

_CLASS_OFFSET = 8192.0  # class-shift floor (actual offset adapts to coords)
SMEM_ROWS = 1024  # K up to which B6's chain stages an image's words in shared memory
# B6's mask words of one pair of launches; a batch whose words exceed it
# runs in chunks of images (N = 32 at K = 8400: two chunks, 71 MB)
SCRATCH_BYTES = 80 << 20

_launch = {}  # the bound C entries, by name, set at their first launch


def nms_keep_plain(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: sweep ``keep = valid & ~(overlap @ keep > 0)``
    from ``keep = valid`` until nothing changes (0/1 sums in fp32 are
    exact). Each sweep waits on the host."""
    ov = overlap.to(torch.float32)
    keep = valid
    for _ in range(overlap.shape[-1]):
        suppressed = torch.bmm(ov, keep.to(torch.float32)[..., None])[..., 0] > 0.0
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def nms_keep(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy suppression: overlap [N, K, K] bool, set at [i, j] only for j
    ranked before i (candidate i overlaps the better j); valid [N, K] bool.
    Returns keep [N, K] bool: valid candidates not overlapping a kept
    better one. On CUDA tensors kernel B6 (its pack pass, then its chain:
    one count); on CPU ones the plain sweeps."""
    if _cuda.routed_through_ops():
        return torch.ops.rva.nms_keep(overlap, valid)
    if overlap.device.type == "cpu" and valid.device.type == "cpu":
        return nms_keep_plain(overlap, valid)
    return _nms_keep_cuda(overlap, valid)


def mask_words(k: int) -> int:
    """B6's mask words of one image: 32 a tile of the upper triangle of
    ceil(K / 32) x ceil(K / 32) tiles (``csrc/nms.cu``)."""
    w = -(-k // 32)
    return 32 * w * (w + 1) // 2


def scratch_chunk(n: int, k: int) -> int:
    """Images a pair of B6 launches takes: as many as ``SCRATCH_BYTES`` of
    mask words hold (at least one), the batch cut into equal chunks."""
    most = max(1, SCRATCH_BYTES // (4 * mask_words(k)))
    parts = -(-n // most)
    return max(1, -(-n // parts))


def _launch_b6(entry: str, source: torch.Tensor, valid: torch.Tensor, *extra) -> torch.Tensor:
    """Allocate keep and the scratch words, call C entry ``entry`` (device,
    source, valid, keep, scratch, n, k, *extra, chunk, stream) and count one
    ``nms_keep`` launch."""
    dev = valid.device
    n, k = valid.shape
    chunk = scratch_chunk(n, k)
    keep = torch.empty((n, k), dtype=torch.bool, device=dev)
    scratch = torch.empty(chunk * mask_words(k), dtype=torch.int32, device=dev)
    fn = _launch.get(entry)
    if fn is None:
        fn = _launch[entry] = _cuda.entry(entry)
    rc = fn(dev.index, source.data_ptr(), valid.data_ptr(), keep.data_ptr(), scratch.data_ptr(),
            n, k, *extra, chunk, _cuda.stream_of(dev.index))
    if rc:
        _cuda.fail(rc, entry)
    _cuda.LAUNCHES.add("nms_keep")
    return keep


def _nms_keep_cuda(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The checks and the launch on CUDA tensors (the wrapper's and the
    op's): B6's pack pass, then its chain."""
    _cuda.require_cuda("nms_keep", overlap, valid)
    if overlap.dtype != torch.bool or valid.dtype != torch.bool:
        raise TypeError(f"nms_keep: overlap and valid must be bool, got {overlap.dtype} "
                        f"and {valid.dtype}")
    if overlap.dim() != 3 or valid.dim() != 2 or tuple(overlap.shape) != (
            valid.shape[0], valid.shape[1], valid.shape[1]):
        raise ValueError(f"nms_keep: need overlap [N, K, K] and valid [N, K], got "
                         f"{tuple(overlap.shape)} and {tuple(valid.shape)}")
    if not (overlap.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep: overlap and valid must be contiguous")
    return _launch_b6("rva_nms_keep", overlap, valid)


@torch.library.custom_op("rva::nms_keep", mutates_args=(), device_types="cpu")
def _nms_keep_op(overlap: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return nms_keep_plain(overlap, valid).clone()


@_nms_keep_op.register_kernel("cuda")
def _(overlap, valid):
    return _nms_keep_cuda(overlap, valid)


@_nms_keep_op.register_fake
def _(overlap, valid):
    return torch.empty_like(valid)


def overlap_matrix(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float) -> torch.Tensor:
    """[N, K, K] bool: candidate i overlaps the better-ranked j (IoU over
    the threshold, strict), both valid: what ``nms_keep`` takes."""
    k = boxes.shape[1]
    iou = iou_matrix(boxes, boxes)  # [N, K, K]
    rank = torch.arange(k, device=boxes.device)
    outranked = rank[None, :, None] > rank[None, None, :]  # j before i
    return (iou > iou_threshold) & outranked & valid[:, None, :] & valid[:, :, None]


def nms_keep_boxes_plain(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    """Plain PyTorch version of ``nms_keep_boxes``: the overlap matrix,
    then the fixpoint sweeps of ``nms_keep_plain``."""
    return nms_keep_plain(overlap_matrix(boxes, valid, iou_threshold), valid)


def nms_keep_boxes(boxes: torch.Tensor, valid: torch.Tensor,
                   iou_threshold: float, mesh=None) -> torch.Tensor:
    """Greedy suppression from the boxes: boxes [N, K, 4] f32 xyxy in rank
    order (class-shifted where NMS is class-aware), valid [N, K] bool.
    Returns keep [N, K] bool, bit-equal to ``nms_keep_boxes_plain``: on
    CUDA tensors kernel B6 (two launches, one count), on CPU ones the plain
    version. ``iou_threshold`` is compared in float32, as PyTorch compares
    an f32 tensor with a Python number. ``mesh``: a device mesh whose dp
    axis splits the batch; the keep pass then runs once per dp shard."""
    if mesh is not None and mesh.shape["dp"] > 1:
        from ..parallel.mesh import dp_map

        return dp_map(lambda b, v: nms_keep_boxes(b, v, iou_threshold), mesh, boxes, valid)
    if _cuda.routed_through_ops():
        return torch.ops.rva.nms_keep_boxes(boxes, valid, float(iou_threshold))
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return nms_keep_boxes_plain(boxes, valid, iou_threshold)
    return _nms_keep_boxes_cuda(boxes, valid, iou_threshold)


def _nms_keep_boxes_cuda(boxes: torch.Tensor, valid: torch.Tensor,
                         iou_threshold: float) -> torch.Tensor:
    _cuda.require_cuda("nms_keep_boxes", boxes, valid)
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"nms_keep_boxes: boxes must be float32 and valid bool, got "
                        f"{boxes.dtype} and {valid.dtype}")
    if boxes.dim() != 3 or valid.dim() != 2 or tuple(boxes.shape) != (
            valid.shape[0], valid.shape[1], 4):
        raise ValueError(f"nms_keep_boxes: need boxes [N, K, 4] and valid [N, K], got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("nms_keep_boxes: boxes and valid must be contiguous")
    return _launch_b6("rva_nms_keep_boxes", boxes, valid, float(iou_threshold))


@torch.library.custom_op("rva::nms_keep_boxes", mutates_args=(), device_types="cpu")
def _nms_keep_boxes_op(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float) -> torch.Tensor:
    return nms_keep_boxes_plain(boxes, valid, iou_threshold).clone()


@_nms_keep_boxes_op.register_kernel("cuda")
def _(boxes, valid, iou_threshold):
    return _nms_keep_boxes_cuda(boxes, valid, iou_threshold)


@_nms_keep_boxes_op.register_fake
def _(boxes, valid, iou_threshold):
    return torch.empty_like(valid)


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
    mesh=None,
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
      mesh:      device mesh for sharded serving (``parallel/mesh.py``): the
                 B1 gathers and B6 then run once per dp shard on that
                 shard's rows (JAX's ``shard_map``'d gathers), the rest on
                 the whole batch; the result is the same.

    Returns:
      (boxes [N, max_det, 4] f32, scores [N, max_det] f32,
       class_ids [N, max_det] int32, num_valid [N] int32) — rows past
      num_valid[i] are zero padding.
    """
    if gather_impl not in ("kernel", "torch"):
        raise ValueError(f"gather_impl must be 'kernel' or 'torch', got {gather_impl!r}")
    gather = row_gather if gather_impl == "kernel" else _torch_gather
    if mesh is not None and gather_impl == "kernel":
        gather = lambda p, i: row_gather(p, i, mesh)  # noqa: E731
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

    # 2. greedy suppression (class-aware: shift classes into disjoint
    #    bands): B6 on the card, the overlap matrix and its sweeps on the CPU
    nms_boxes = top_boxes
    if not class_agnostic:
        lo = top_boxes.min()
        offset = torch.clamp_min(top_boxes.max() - lo, _CLASS_OFFSET) + 1.0
        nms_boxes = (top_boxes - lo) + (
            top_classes.to(top_boxes.dtype) * offset
        )[..., None]
    keep = (nms_keep_boxes(nms_boxes, valid, iou_threshold) if mesh is None
            else nms_keep_boxes(nms_boxes, valid, iou_threshold, mesh=mesh))

    # 3. stable compaction, kept rows first in score order
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
