"""COCO-style detection metrics in pure NumPy.

Implements the standard evaluation protocol (greedy score-ordered matching
per IoU threshold, 101-point interpolated AP, mAP@[.5:.95]) without
pycocotools, so the evaluator runs in this image and in CI.

Protocol notes (matching the published COCO evaluation semantics):
  * detections are sorted by confidence (descending) per class;
  * a detection matches the unmatched ground-truth box of the same class
    with the highest IoU >= threshold (greedy, one GT per detection);
  * AP integrates precision over recall at 101 recall points
    [0, 0.01, ..., 1.0], with the precision envelope made monotonically
    non-increasing first;
  * mAP averages AP over IoU thresholds 0.50:0.05:0.95 and over classes
    that have at least one ground-truth instance.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

IOU_THRESHOLDS = tuple(np.round(np.arange(0.5, 0.96, 0.05), 2))
RECALL_POINTS = np.linspace(0.0, 1.0, 101)


@dataclass
class DetectionSample:
    """One image's detections + ground truth (arrays may be empty).

    det_boxes: [D, 4] xyxy; det_scores: [D]; det_classes: [D] int
    gt_boxes:  [G, 4] xyxy; gt_classes: [G] int
    """

    det_boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))
    det_scores: np.ndarray = field(default_factory=lambda: np.zeros((0,)))
    det_classes: np.ndarray = field(default_factory=lambda: np.zeros((0,), int))
    gt_boxes: np.ndarray = field(default_factory=lambda: np.zeros((0, 4)))
    gt_classes: np.ndarray = field(default_factory=lambda: np.zeros((0,), int))


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes: [len(a), len(b)]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / union, 0.0)


def match_detections(
    det_boxes: np.ndarray,
    det_scores: np.ndarray,
    gt_boxes: np.ndarray,
    iou_thr: float,
) -> np.ndarray:
    """Greedy score-ordered matching for one class in one image.

    Returns a bool array over detections (sorted order of the *input*):
    True = matched a GT (TP), False = FP. Each GT matches at most once.
    """
    d = len(det_boxes)
    tp = np.zeros((d,), bool)
    if d == 0 or len(gt_boxes) == 0:
        return tp
    order = np.argsort(-np.asarray(det_scores), kind="stable")
    ious = iou_matrix(np.asarray(det_boxes)[order], gt_boxes)
    taken = np.zeros((len(gt_boxes),), bool)
    for r, di in enumerate(order):
        cand = np.where(~taken & (ious[r] >= iou_thr))[0]
        if len(cand):
            best = cand[np.argmax(ious[r, cand])]
            taken[best] = True
            tp[di] = True
    return tp


def average_precision(
    tp: np.ndarray, scores: np.ndarray, n_gt: int
) -> float:
    """101-point interpolated AP from per-detection TP flags (any order;
    sorted here by score) and the class's total ground-truth count."""
    if n_gt == 0:
        return float("nan")
    if len(tp) == 0:
        return 0.0
    order = np.argsort(-np.asarray(scores), kind="stable")
    tp = np.asarray(tp, bool)[order]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(~tp)
    recall = cum_tp / n_gt
    precision = cum_tp / np.maximum(cum_tp + cum_fp, 1)
    # monotone precision envelope (right-to-left max)
    precision = np.maximum.accumulate(precision[::-1])[::-1]
    # precision at each of the 101 recall points (0 past max recall)
    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
    p_at = np.where(idx < len(precision), precision[np.minimum(idx, len(precision) - 1)], 0.0)
    return float(p_at.mean())


def evaluate_detections(
    samples: Sequence[DetectionSample],
    iou_thresholds: Sequence[float] = IOU_THRESHOLDS,
    classes: Optional[Sequence[int]] = None,
) -> Dict:
    """COCO-style evaluation over a dataset.

    Returns {"map": mAP@[.5:.95], "map50": AP@0.5, "map75": AP@0.75,
    "per_class": {cid: {"ap": ..., "ap50": ..., "n_gt": ...}},
    "n_images": N, "n_detections": D, "n_gt": G}.
    """
    if classes is None:
        cset = set()
        for s in samples:
            cset.update(np.asarray(s.gt_classes, int).tolist())
            cset.update(np.asarray(s.det_classes, int).tolist())
        classes = sorted(cset)

    # per (class, iou): gather TP flags + scores across images
    per_class: Dict[int, Dict] = {}
    ap_table = np.full((len(classes), len(iou_thresholds)), np.nan)
    for ci, cid in enumerate(classes):
        n_gt = 0
        scores_all: List[np.ndarray] = []
        tp_by_thr: List[List[np.ndarray]] = [[] for _ in iou_thresholds]
        for s in samples:
            dmask = np.asarray(s.det_classes, int) == cid
            gmask = np.asarray(s.gt_classes, int) == cid
            n_gt += int(gmask.sum())
            if dmask.any():
                db = np.asarray(s.det_boxes)[dmask]
                ds = np.asarray(s.det_scores)[dmask]
                scores_all.append(ds)
                gb = np.asarray(s.gt_boxes)[gmask] if gmask.any() else np.zeros((0, 4))
                for ti, thr in enumerate(iou_thresholds):
                    tp_by_thr[ti].append(match_detections(db, ds, gb, thr))
        scores = np.concatenate(scores_all) if scores_all else np.zeros((0,))
        for ti in range(len(iou_thresholds)):
            tp = (
                np.concatenate(tp_by_thr[ti]) if tp_by_thr[ti] else np.zeros((0,), bool)
            )
            ap_table[ci, ti] = average_precision(tp, scores, n_gt)
        # ap50 must be the AP at IoU 0.5, not column 0 (a custom
        # iou_thresholds list may not start at — or contain — 0.5)
        i50 = (
            list(iou_thresholds).index(0.5) if 0.5 in iou_thresholds else None
        )
        per_class[int(cid)] = {
            "ap": float(np.nanmean(ap_table[ci])) if n_gt else float("nan"),
            "ap50": (
                float(ap_table[ci, i50])
                if n_gt and i50 is not None else float("nan")
            ),
            "n_gt": n_gt,
        }

    valid = ~np.isnan(ap_table).all(axis=1)
    thr_list = [float(t) for t in iou_thresholds]

    def _mean_at(thr: float) -> float:
        if thr not in thr_list or not valid.any():
            return float("nan")
        col = ap_table[valid, thr_list.index(thr)]
        return float(np.nanmean(col))

    return {
        "map": float(np.nanmean(ap_table[valid])) if valid.any() else float("nan"),
        "map50": _mean_at(0.5),
        "map75": _mean_at(0.75),
        "per_class": per_class,
        "n_images": len(samples),
        "n_detections": int(sum(len(s.det_scores) for s in samples)),
        "n_gt": int(sum(len(s.gt_classes) for s in samples)),
    }
