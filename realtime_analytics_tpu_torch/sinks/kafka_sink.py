"""Event sink with Kafka-wire-compatible payloads and pluggable transports.

Payload contract (bit-compatible with reference sinks/kafka_sink.py:93-149):

    {"stream": name, "frame_id": id, "tracks": [{track_id, class_id,
      confidence, bbox_xyxy, [action_label, temporal_score,
      sequence_start_frame, sequence_end_frame]}], "is_temporal": bool,
      ["frame_jpeg": "data:image/...;base64,..."]}

Behavior preserved from the reference:
  * per-stream frame-preview rate limit (default 0.1 s => max 10 FPS;
    configurable here instead of hardcoded — kafka_sink.py:48),
  * adaptive JPEG/WebP quality from detection count (+/-10, clamp [50, 95] —
    kafka_sink.py:165-192),
  * frames rendered (boxes + "ID n" labels, downscale to <=1920x1080) in a
    worker thread, WebP when quality >= 80 (kafka_sink.py:200-294),
  * sends serialized under a lock.

Transports (config ``kafka.transport``):
  * ``kafka``   — aiokafka producer (requires aiokafka; falls back to
                  ``jsonl``/disabled with a warning when missing)
  * ``eventbus``— the in-repo TCP broker (bootstrap_servers = host:port)
  * ``jsonl``   — newline-delimited JSON file (``kafka.jsonl_path``)
  * ``memory``  — in-process buffer (tests)
"""

from __future__ import annotations

import asyncio
import base64
import json
import logging
import time
from typing import Dict, Iterable, List, Optional

import numpy as np

from ..config import KafkaSinkConfig
from ..types import Track
from .eventbus import EventBusPublisher

logger = logging.getLogger(__name__)

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


class KafkaSink:
    def __init__(self, config: KafkaSinkConfig):
        self.config = config
        self._producer = None  # aiokafka producer
        self._bus: Optional[EventBusPublisher] = None
        self._jsonl_file = None
        self.memory_buffer: List[dict] = []
        self._lock = asyncio.Lock()
        self._last_frame_time: Dict[str, float] = {}
        self._transport = config.transport
        self.messages_sent = 0
        # last failed eventbus reconnect (monotonic); a dead broker must
        # degrade to fast drops, not serialize every event behind a full
        # TCP connect timeout while _publish holds the lock
        self._bus_reconnect_failed_at: Optional[float] = None
        self._bus_reconnect_cooldown_s = 5.0
        self.messages_dropped = 0
        self._last_drop_log = 0.0

    # -- lifecycle -----------------------------------------------------------

    async def connect(self) -> None:
        if not self.config.enabled:
            return
        if self._transport == "kafka":
            try:
                from aiokafka import AIOKafkaProducer  # type: ignore
            except ImportError:
                logger.warning(
                    "aiokafka not installed — falling back to jsonl transport"
                )
                self._transport = "jsonl"
            else:
                self._producer = AIOKafkaProducer(
                    bootstrap_servers=self.config.bootstrap_servers,
                    linger_ms=self.config.linger_ms,
                    max_batch_size=self.config.max_batch_size,
                    value_serializer=lambda v: json.dumps(v).encode("utf-8"),
                )
                await self._producer.start()
                logger.info(
                    "Kafka producer connected to %s", self.config.bootstrap_servers
                )
                return
        if self._transport == "eventbus":
            host, _, port = self.config.bootstrap_servers.partition(":")
            self._bus = EventBusPublisher(host or "127.0.0.1", int(port or 9192))
            await self._bus.connect()
            logger.info("EventBus publisher connected to %s", self.config.bootstrap_servers)
        elif self._transport == "jsonl":
            path = self.config.jsonl_path or "analytics_events.jsonl"
            self._jsonl_file = open(path, "a", encoding="utf-8")  # noqa: SIM115
            logger.info("JSONL sink writing to %s", path)

    async def close(self) -> None:
        if self._producer is not None:
            await self._producer.stop()
            self._producer = None
        if self._bus is not None:
            await self._bus.close()
            self._bus = None
        if self._jsonl_file is not None:
            self._jsonl_file.close()
            self._jsonl_file = None

    # -- publishing ----------------------------------------------------------

    async def send_tracks(
        self,
        stream_name: str,
        frame_id: int,
        tracks: Iterable[Track],
        frame: Optional[np.ndarray] = None,
        health: Optional[float] = None,
        fps: Optional[float] = None,
    ) -> None:
        if not self.config.enabled:
            return
        track_list = []
        has_temporal = False
        for track in tracks:
            d = {
                "track_id": track.track_id,
                "class_id": track.class_id,
                "confidence": track.confidence,
                "bbox_xyxy": list(track.bbox_xyxy),
            }
            if track.action_label is not None:
                d["action_label"] = track.action_label
                has_temporal = True
            if track.temporal_score is not None:
                d["temporal_score"] = track.temporal_score
            if track.sequence_start_frame is not None:
                d["sequence_start_frame"] = track.sequence_start_frame
            if track.sequence_end_frame is not None:
                d["sequence_end_frame"] = track.sequence_end_frame
            track_list.append(d)

        payload = {
            "stream": stream_name,
            "frame_id": frame_id,
            "tracks": track_list,
            "is_temporal": has_temporal,
        }
        # additive telemetry keys (the reference frontend reads event.health
        # / event.fps but its pipeline never publishes them — fixed here)
        if health is not None:
            payload["health"] = round(float(health), 4)
        if fps is not None:
            payload["fps"] = round(float(fps), 2)
        if (
            self.config.include_frames
            and frame is not None
            and _HAS_CV2
            and self._should_send_frame(stream_name)
        ):
            try:
                quality = self._calculate_adaptive_quality(len(track_list))
                payload["frame_jpeg"] = await asyncio.to_thread(
                    self._render_frame, frame, track_list, quality
                )
            except Exception:  # noqa: BLE001
                logger.exception(
                    "Failed to encode frame preview for stream '%s'", stream_name
                )
        await self._publish(payload)

    async def _publish(self, payload: dict) -> None:
        async with self._lock:
            if self._producer is not None:
                await self._producer.send_and_wait(self.config.topic, payload)
            elif self._bus is not None:
                try:
                    await self._bus.publish(self.config.topic, payload)
                except (ConnectionError, RuntimeError, OSError):
                    # broker restarted: the producer side must reconnect
                    # like the consumer side does, or every event after
                    # the drop is silently lost for the process lifetime.
                    # But only retry once per cooldown window — a
                    # black-holed broker would otherwise stall every
                    # send_tracks behind a full connect timeout under
                    # self._lock. Failures are ABSORBED here (dropped +
                    # rate-limit-logged), never raised: a dead event bus
                    # must not mark served frames as processing failures
                    # in the completion loop (health scores, adaptive
                    # scheduling), nor traceback per frame at 800 fps.
                    now = time.monotonic()
                    last_fail = self._bus_reconnect_failed_at
                    if (
                        last_fail is not None
                        and now - last_fail < self._bus_reconnect_cooldown_s
                    ):
                        self._drop(now)
                        return
                    logger.warning(
                        "eventbus publish failed; reconnecting to %s:%s",
                        self._bus.host, self._bus.port,
                    )
                    await self._bus.close()
                    try:
                        await self._bus.connect()
                        await self._bus.publish(self.config.topic, payload)
                    except (ConnectionError, RuntimeError, OSError):
                        self._bus_reconnect_failed_at = time.monotonic()
                        self._drop(self._bus_reconnect_failed_at)
                        return
                    self._bus_reconnect_failed_at = None
            elif self._jsonl_file is not None:
                self._jsonl_file.write(json.dumps(payload) + "\n")
                self._jsonl_file.flush()
            elif self._transport == "memory":
                self.memory_buffer.append(payload)
            else:
                return
            self.messages_sent += 1

    def _drop(self, now: float) -> None:
        """Account an event dropped while the bus is down; warn at most
        once per cooldown window (not per frame — 32 streams x 25 fps of
        tracebacks is itself a host load)."""
        self.messages_dropped += 1
        if now - self._last_drop_log >= self._bus_reconnect_cooldown_s:
            self._last_drop_log = now
            logger.warning(
                "event bus unreachable — %d event(s) dropped so far "
                "(reconnect every %.0fs)",
                self.messages_dropped, self._bus_reconnect_cooldown_s,
            )

    # -- rate limiting & rendering -------------------------------------------

    def _should_send_frame(self, stream_name: str) -> bool:
        # monotonic: a backwards wall-clock step (NTP sync) must not
        # suppress previews for the size of the step
        now = time.monotonic()
        last = self._last_frame_time.get(stream_name)
        if last is None or now - last >= self.config.frame_interval_seconds:
            self._last_frame_time[stream_name] = now
            return True
        return False

    def _calculate_adaptive_quality(self, detection_count: int) -> int:
        base = self.config.frame_quality
        if detection_count == 0:
            boost = -10
        elif detection_count <= 3:
            boost = 0
        elif detection_count <= 10:
            boost = 5
        else:
            boost = 10
        return max(50, min(95, base + boost))

    def _render_frame(
        self, frame: np.ndarray, track_list: List[dict], quality: int
    ) -> str:
        img = frame.copy()
        h, w = img.shape[:2]
        if w > 1920 or h > 1080:
            scale = min(1920 / w, 1080 / h)
            img = cv2.resize(img, (int(w * scale), int(h * scale)))
            sx = img.shape[1] / w
            sy = img.shape[0] / h
        else:
            sx = sy = 1.0
        for t in track_list:
            x1, y1, x2, y2 = t["bbox_xyxy"]
            p1 = (int(x1 * sx), int(y1 * sy))
            p2 = (int(x2 * sx), int(y2 * sy))
            color = self._color_for(t["class_id"])
            cv2.rectangle(img, p1, p2, color, 2)
            label = f"ID {t['track_id']}"
            (tw, th), baseline = cv2.getTextSize(
                label, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1
            )
            cv2.rectangle(
                img, (p1[0], p1[1] - th - baseline - 2), (p1[0] + tw, p1[1]), color, -1
            )
            cv2.putText(
                img, label, (p1[0], p1[1] - baseline - 1),
                cv2.FONT_HERSHEY_SIMPLEX, 0.5, (255, 255, 255), 1, cv2.LINE_AA,
            )
        use_webp = quality >= 80
        if use_webp:
            ok, buf = cv2.imencode(".webp", img, [cv2.IMWRITE_WEBP_QUALITY, quality])
            mime = "image/webp"
            if not ok:
                use_webp = False
        if not use_webp:
            ok, buf = cv2.imencode(
                ".jpg",
                img,
                [
                    cv2.IMWRITE_JPEG_QUALITY, quality,
                    cv2.IMWRITE_JPEG_PROGRESSIVE, 1,
                    cv2.IMWRITE_JPEG_OPTIMIZE, 1,
                ],
            )
            mime = "image/jpeg"
        if not ok:
            raise RuntimeError("image encode failed")
        return f"data:{mime};base64," + base64.b64encode(buf.tobytes()).decode()

    @staticmethod
    def _color_for(class_id: int) -> tuple:
        rng = np.random.default_rng(abs(hash(class_id)) % (2**32))
        b, g, r = rng.integers(60, 256, 3)
        return int(b), int(g), int(r)
