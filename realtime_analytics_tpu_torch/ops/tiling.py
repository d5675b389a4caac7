"""Tiled (sliced) small-object inference: the host-side slicing math.

Counterpart of ``realtime_analytics_tpu/ops/tiling.py`` (numpy only, copied
so that the port imports nothing of the JAX package). The reference always
letterboxes the whole frame (reference detector.py:224-268), so a 1080p
frame reaches a 640-input model at 1/3 scale and small objects vanish.
SAHI-style slicing cuts the frame into input-sized tiles and detects at
native resolution:

* every tile is exactly the model input size, so tiles ride the same
  selected step as whole frames (an identity pixel pick), and cropping is
  a memcpy, never a resize;
* tiles across frames and streams batch together through the engine's
  buckets (8 tiles per 1080p frame at 640x640);
* only the merge (tile-to-frame offset and seam dedup) runs on the host,
  on a few hundred boxes.

Seam dedup uses intersection-over-smaller (IoS): a box cut at a tile seam
is a strict subset of the full box seen by the neighbouring tile, so its
IoU against the full box can sit well under the NMS threshold while its
IoS is ~1.0.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def tile_grid(
    src_hw: Tuple[int, int], tile_hw: Tuple[int, int], overlap: float
) -> List[Tuple[int, int]]:
    """Tile origins (y0, x0) covering ``src_hw`` with ``tile_hw`` tiles.

    Stride is ``tile * (1 - overlap)`` per axis; the last tile per axis is
    clamped flush to the frame edge so coverage is exact without ragged
    shapes. Axes smaller than the tile produce a single origin at 0 (the
    crop pads with the letterbox fill).
    """
    sh, sw = src_hw
    th, tw = tile_hw

    def axis(src: int, tile: int) -> List[int]:
        if src <= tile:
            return [0]
        stride = max(1, int(round(tile * (1.0 - overlap))))
        # range() stops strictly below src - tile, so the appended flush
        # origin is always a new, larger value — the list is sorted unique
        xs = list(range(0, src - tile, stride))
        xs.append(src - tile)  # flush to the edge
        return xs

    return [(y, x) for y in axis(sh, th) for x in axis(sw, tw)]


def crop_tile(
    frame: np.ndarray, y0: int, x0: int, tile_hw: Tuple[int, int],
    out: np.ndarray, fill: int = 114,
) -> None:
    """Copy ``frame[y0:, x0:]`` into ``out`` ([th, tw, 3] uint8), padding
    bottom/right with the letterbox fill when the frame is smaller than the
    tile. One memcpy — never a resize."""
    th, tw = tile_hw
    h = min(th, frame.shape[0] - y0)
    w = min(tw, frame.shape[1] - x0)
    if h < th or w < tw:
        out[...] = fill
    out[:h, :w] = frame[y0: y0 + h, x0: x0 + w]


def _ios_matrix(boxes: np.ndarray) -> np.ndarray:
    """Pairwise intersection-over-smaller-area for [K, 4] xyxy boxes."""
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = np.clip(boxes[:, 2] - boxes[:, 0], 0, None) * np.clip(
        boxes[:, 3] - boxes[:, 1], 0, None
    )
    smaller = np.minimum(area[:, None], area[None, :])
    return inter / np.maximum(smaller, 1e-9)


def merge_tile_detections(
    boxes: np.ndarray,
    scores: np.ndarray,
    class_ids: np.ndarray,
    ios_threshold: float,
    max_detections: int,
    class_agnostic: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Greedy seam dedup over already-offset global-coordinate detections.

    Keeps boxes in descending score order, suppressing any lower-scored box
    whose IoS with a kept box exceeds ``ios_threshold`` (same class unless
    ``class_agnostic``). Returns (boxes [max_det, 4], scores [max_det],
    classes [max_det], n) zero-padded past ``n``.
    """
    ob = np.zeros((max_detections, 4), np.float32)
    os_ = np.zeros((max_detections,), np.float32)
    oc = np.zeros((max_detections,), np.int32)
    k = len(scores)
    if k == 0:
        return ob, os_, oc, 0
    order = np.argsort(-scores, kind="stable")
    boxes, scores, class_ids = boxes[order], scores[order], class_ids[order]
    ios = _ios_matrix(boxes)
    keep: List[int] = []
    alive = np.ones(k, bool)
    for i in range(k):
        if not alive[i]:
            continue
        keep.append(i)
        if len(keep) >= max_detections:
            break
        over = ios[i] > ios_threshold
        if not class_agnostic:
            over &= class_ids == class_ids[i]
        over[: i + 1] = False
        alive &= ~over
    n = len(keep)
    ob[:n] = boxes[keep]
    os_[:n] = scores[keep]
    oc[:n] = class_ids[keep]
    return ob, os_, oc, n


def offset_and_clip(
    boxes: np.ndarray, y0: int, x0: int, src_hw: Tuple[int, int]
) -> np.ndarray:
    """Tile-local xyxy boxes -> frame coordinates, clipped to the frame."""
    sh, sw = src_hw
    out = boxes + np.asarray([x0, y0, x0, y0], np.float32)
    out[:, 0::2] = np.clip(out[:, 0::2], 0, sw)
    out[:, 1::2] = np.clip(out[:, 1::2], 0, sh)
    return out


def merge_frame(
    tile_results: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray, int]],
    grid: Sequence[Tuple[int, int]],
    src_hw: Tuple[int, int],
    ios_threshold: float,
    max_detections: int,
    class_agnostic: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Merge one frame's per-tile padded results (+ optional extra passes).

    ``tile_results[t]`` = (boxes [D,4], scores [D], classes [D], n) in
    TILE coordinates for grid[t]; entries beyond ``len(grid)`` (e.g. a
    whole-frame pass) are taken as already being in frame coordinates.
    """
    all_b: List[np.ndarray] = []
    all_s: List[np.ndarray] = []
    all_c: List[np.ndarray] = []
    for t, (b, s, c, n) in enumerate(tile_results):
        if n == 0:
            continue
        b = np.asarray(b[:n], np.float32)
        if t < len(grid):
            y0, x0 = grid[t]
            b = offset_and_clip(b, y0, x0, src_hw)
        all_b.append(b)
        all_s.append(np.asarray(s[:n], np.float32))
        all_c.append(np.asarray(c[:n], np.int32))
    if not all_b:
        return merge_tile_detections(
            np.zeros((0, 4), np.float32), np.zeros((0,), np.float32),
            np.zeros((0,), np.int32), ios_threshold, max_detections,
            class_agnostic,
        )
    return merge_tile_detections(
        np.concatenate(all_b), np.concatenate(all_s), np.concatenate(all_c),
        ios_threshold, max_detections, class_agnostic,
    )
