"""The comparison that decides ``correct``: served detections against the
plain reference (``reference/yolov8.py``), frame by frame, counted over
every frame a run samples.

* ``served_off``: the share, in %, of served detections that the reference
  does not score alike. A served detection (box ``b``, class ``c``, score
  ``s``) has the gap ``min over the reference's anchors a of max(|P[a, c] -
  s|, max|B[a] - b| / BOX_PX)`` (``P`` the reference's class probabilities,
  ``B`` its boxes in frame pixels; a box ``BOX_PX`` pixels off weighs as a
  score off by 1), and is off where the gap is over ``SERVED_TOL``. A
  detection moved, rescored, relabelled or taken from another frame is off.
* ``missed``: the share, in %, of the reference's clear detections that no
  served detection covers. A reference detection ``r`` is clear where its
  score is ``MARGIN`` above the frame's ``cut`` (the threshold, or where the
  top-k or the detection limit cut) and its box lies inside the frame. It
  is covered by a served detection that overlaps it by IoU over
  ``COVER_IOU`` and scores at least ``r``'s score less ``SCORE_SLACK``:
  class-agnostic greedy NMS keeps ``r`` or drops it for a better-scored box
  that overlaps it by more than 0.45 (on the boxes before the clip to the
  frame; clipping the other box only raises its IoU with a box inside the
  frame). ``COVER_IOU`` lies under 0.45 and ``SCORE_SLACK`` over the
  scores' rounding, as the box rounding of a sound run moves IoUs and
  scores. A frame left out or answered empty misses all its clear
  detections.

A deep network with random weights amplifies rounding: in bf16 a few
detections in a thousand move by tens of pixels or a few hundredths of
score. So the numbers are shares over thousands of detections, and their
limits lie between what sound runs and the control read (``PERF.md``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch

from .reference.yolov8 import Anchors, Detections, iou_matrix

BOX_PX = 1024.0
SERVED_TOL = 0.1
MARGIN = 0.02
COVER_IOU = 0.40
SCORE_SLACK = 0.10


def served_gaps(anchors: Anchors, boxes: np.ndarray, scores: np.ndarray,
                classes: np.ndarray) -> torch.Tensor:
    """Each served detection's gap (boxes [D, 4] frame pixels)."""
    dev = anchors.probs.device
    if len(scores) == 0:
        return torch.zeros(0)
    b = torch.as_tensor(boxes, dtype=torch.float32, device=dev)
    s = torch.as_tensor(scores, dtype=torch.float32, device=dev)
    c = torch.as_tensor(classes, dtype=torch.long, device=dev)
    score_gap = (anchors.probs[:, c] - s[None, :]).abs()  # [A, D]
    box_gap = (anchors.boxes[:, None, :] - b[None, :, :]).abs().amax(-1) / BOX_PX
    return torch.maximum(score_gap, box_gap).amin(0).cpu()


def clear_uncovered(ref: Detections, boxes: np.ndarray, scores: np.ndarray):
    """(clear reference detections, those of them no served detection covers)."""
    clear = (ref.scores >= ref.cut + MARGIN) & ref.inside
    n = int(clear.sum())
    if n == 0 or len(scores) == 0:
        return n, n
    r_boxes, r_scores = torch.as_tensor(ref.boxes[clear]), torch.as_tensor(ref.scores[clear])
    s = torch.as_tensor(scores, dtype=torch.float32)
    cover = (iou_matrix(r_boxes, torch.as_tensor(boxes, dtype=torch.float32)) > COVER_IOU) & \
        (s[None, :] >= r_scores[:, None] - SCORE_SLACK)
    return n, int((~cover.any(1)).sum())


def frame_counts(anchors: Anchors, ref: Detections, boxes: np.ndarray, scores: np.ndarray,
                 classes: np.ndarray) -> Dict[str, int]:
    gaps = served_gaps(anchors, boxes, scores, classes)
    clear, uncovered = clear_uncovered(ref, boxes, scores)
    return {"served": len(gaps), "off": int((gaps > SERVED_TOL).sum()),
            "clear": clear, "uncovered": uncovered}


def shares(counts: Iterable[Dict[str, int]]) -> Dict[str, Optional[float]]:
    """The run's two numbers, in %, from its frames' counts."""
    total: Dict[str, int] = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    pct = lambda a, b: 100.0 * total[a] / total[b] if total.get(b) else None  # noqa: E731
    return {"served_off": pct("off", "served"), "missed": pct("uncovered", "clear")}

