"""Wire schemas for the dashboard (reference api/schemas.py:13-48).

The WebSocket protocol is ``{"type": "snapshot" | "event", "payload": ...}``
and event payloads mirror the Kafka JSON exactly, so the reference's
dashboard frontend and this one are interchangeable consumers.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import List, Optional

from pydantic import BaseModel, Field


class TrackPayload(BaseModel):
    track_id: int
    class_id: int
    confidence: float
    bbox_xyxy: List[float]
    # temporal extras (the reference's consumer drops these on parse,
    # api/kafka_consumer.py:116-121 — fixed here: they round-trip)
    action_label: Optional[str] = None
    temporal_score: Optional[float] = None
    sequence_start_frame: Optional[int] = None
    sequence_end_frame: Optional[int] = None


def _utcnow() -> datetime:
    return datetime.now(timezone.utc)


class DetectionEvent(BaseModel):
    stream: str
    frame_id: int
    tracks: List[TrackPayload] = Field(default_factory=list)
    received_at: datetime = Field(default_factory=_utcnow)
    frame_jpeg: Optional[str] = None
    is_temporal: bool = False
    # per-stream telemetry, published by the pipeline (additive keys)
    health: Optional[float] = None
    fps: Optional[float] = None


class DashboardSnapshot(BaseModel):
    events: List[DetectionEvent] = Field(default_factory=list)
    generated_at: datetime = Field(default_factory=_utcnow)


class WsEnvelope(BaseModel):
    type: str  # "snapshot" | "event"
    payload: dict


def parse_event(payload: dict) -> Optional[DetectionEvent]:
    """Parse one bus message into a DetectionEvent (None on junk)."""
    try:
        return DetectionEvent(
            stream=payload["stream"],
            frame_id=int(payload.get("frame_id", 0)),
            tracks=[TrackPayload(**t) for t in payload.get("tracks", [])],
            frame_jpeg=payload.get("frame_jpeg"),
            is_temporal=bool(payload.get("is_temporal", False)),
            health=payload.get("health"),
            fps=payload.get("fps"),
        )
    except (KeyError, TypeError, ValueError):
        return None
