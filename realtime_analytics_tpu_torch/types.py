"""Core datatypes shared across the pipeline.

Mirrors the observable contract of the reference:
  * ``FramePacket``   — reference ``video_stream.py:26-33``
  * ``Detection``     — reference ``detector.py:32-40``
  * ``Track``         — reference ``tracker.py:18-33``
  * ``TemporalDetection`` — reference ``temporal_detector.py:35-47``

These are plain host-side containers; on-device data lives in padded
fixed-shape arrays (see ``realtime_analytics_tpu_torch.ops``) and is converted to
these types only at the pipeline boundary.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, List, Optional, Tuple

import numpy as np

if TYPE_CHECKING:  # pragma: no cover
    from .config import StreamConfig


@dataclass(slots=True)
class FramePacket:
    """A single decoded video frame plus provenance."""

    stream: "StreamConfig"
    frame: np.ndarray  # BGR uint8, HxWx3
    frame_id: int
    timestamp: float


@dataclass(slots=True)
class Detection:
    """One detected object on one frame (boxes in original-frame pixels)."""

    stream_name: str
    frame_id: int
    class_id: int
    confidence: float
    bbox_xyxy: Tuple[float, float, float, float]


@dataclass(slots=True)
class TemporalDetection(Detection):
    """A detection produced by a temporal (clip-level) model."""

    action_label: str = ""
    temporal_score: float = 0.0
    sequence_start_frame: int = 0
    sequence_end_frame: int = 0


@dataclass(slots=True)
class Track:
    """A tracked object with lifecycle counters."""

    track_id: int
    stream_name: str
    class_id: int
    confidence: float
    bbox_xyxy: Tuple[float, float, float, float]
    age: int = 0
    hits: int = 1
    # Optional temporal fields, populated when the source detection is a
    # TemporalDetection (reference passes these through by duck typing,
    # tracker.py:58-67).
    action_label: Optional[str] = None
    temporal_score: Optional[float] = None
    sequence_start_frame: Optional[int] = None
    sequence_end_frame: Optional[int] = None

    def as_dict(self) -> dict:
        d = {
            "track_id": self.track_id,
            "class_id": self.class_id,
            "confidence": round(float(self.confidence), 4),
            "bbox_xyxy": [round(float(v), 2) for v in self.bbox_xyxy],
            "age": self.age,
            "hits": self.hits,
        }
        if self.action_label is not None:
            d["action_label"] = self.action_label
            d["temporal_score"] = round(float(self.temporal_score or 0.0), 4)
            d["sequence_start_frame"] = self.sequence_start_frame
            d["sequence_end_frame"] = self.sequence_end_frame
        return d


@dataclass(slots=True)
class BatchResult:
    """Padded device-side detection results for one batched inference step.

    All arrays are host numpy after device->host transfer. ``num_valid[i]``
    gives the number of real detections for image ``i``; rows beyond that are
    padding.
    """

    boxes_xyxy: np.ndarray  # [N, D, 4] float32, original-frame pixels
    scores: np.ndarray  # [N, D] float32
    class_ids: np.ndarray  # [N, D] int32
    num_valid: np.ndarray  # [N] int32

    def to_detections(
        self, stream_names: List[str], frame_ids: List[int]
    ) -> List[List[Detection]]:
        out: List[List[Detection]] = []
        for i in range(len(stream_names)):
            n = int(self.num_valid[i])
            dets = [
                Detection(
                    stream_name=stream_names[i],
                    frame_id=frame_ids[i],
                    class_id=int(self.class_ids[i, j]),
                    confidence=float(self.scores[i, j]),
                    bbox_xyxy=tuple(float(v) for v in self.boxes_xyxy[i, j]),
                )
                for j in range(n)
            ]
            out.append(dets)
        return out


def filter_detections(
    detections: List[Detection], min_confidence: float
) -> List[Detection]:
    """Confidence re-filter applied post-predict (reference detector.py:99-103)."""
    return [d for d in detections if d.confidence >= min_confidence]
