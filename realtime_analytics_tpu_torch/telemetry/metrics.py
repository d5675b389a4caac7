"""Prometheus metrics publisher.

Metric-name compatible with the reference (telemetry/metrics.py:55-93):
  stream_frames_total{stream}, stream_detections_total{stream},
  stream_active_tracks{stream}, temporal_sequences_total{stream},
  temporal_buffer_size{stream}, temporal_inference_duration_seconds{stream}.

Two fixes over the reference:
  * ``update_temporal_metrics`` is actually wired into the pipeline (the
    reference defines it with zero call sites — metrics.py:140-172);
  * TPU-specific batcher metrics are added: batch size histogram and device
    inference latency histogram.

Degrades to a no-op when prometheus_client is unavailable.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ..config import PrometheusConfig

logger = logging.getLogger(__name__)

try:
    from prometheus_client import Counter, Gauge, Histogram, start_http_server

    _HAS_PROM = True
except ImportError:  # pragma: no cover
    _HAS_PROM = False


_LATENCY_BUCKETS = (0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0)
_BATCH_BUCKETS = (1, 2, 4, 8, 16, 24, 32)


class MetricsPublisher:
    def __init__(self, config: PrometheusConfig):
        self.config = config
        self._initialized = False
        self._ticker: Optional[asyncio.Task] = None
        self._frames = None
        self._detections = None
        self._active_tracks = None
        self._temporal_sequences = None
        self._temporal_buffer = None
        self._temporal_latency = None
        self._batch_size = None
        self._device_latency = None
        self._shed = None
        self._uptime = None

    def _lazy_init(self) -> None:
        if self._initialized or not _HAS_PROM:
            return
        self._frames = Counter(
            "stream_frames_total", "Frames processed per stream", ["stream"]
        )
        self._detections = Counter(
            "stream_detections_total", "Detections emitted per stream", ["stream"]
        )
        self._active_tracks = Gauge(
            "stream_active_tracks", "Currently active tracks per stream", ["stream"]
        )
        self._temporal_sequences = Counter(
            "temporal_sequences_total", "Temporal sequences inferred", ["stream"]
        )
        self._temporal_buffer = Gauge(
            "temporal_buffer_size", "Frames buffered for temporal models", ["stream"]
        )
        self._temporal_latency = Histogram(
            "temporal_inference_duration_seconds",
            "Temporal inference latency",
            ["stream"],
            buckets=_LATENCY_BUCKETS,
        )
        self._batch_size = Histogram(
            "device_batch_size", "Frames per device batch", buckets=_BATCH_BUCKETS
        )
        self._device_latency = Histogram(
            "device_inference_duration_seconds",
            "Fused device step latency",
            buckets=_LATENCY_BUCKETS,
        )
        self._shed = Counter(
            "stream_frames_shed_total",
            "Frames shed by the per-stream in-flight cap", ["stream"],
        )
        self._uptime = Gauge(
            "pipeline_uptime_seconds", "Seconds since the pipeline started"
        )
        self._initialized = True

    async def start(self) -> None:
        if not self.config.enabled:
            return
        if not _HAS_PROM:
            logger.warning("prometheus_client missing — metrics disabled")
            return
        self._lazy_init()
        start_http_server(self.config.port, addr=self.config.host)
        logger.info(
            "Prometheus metrics on http://%s:%d/metrics",
            self.config.host, self.config.port,
        )
        self._ticker = asyncio.create_task(self._tick())

    async def stop(self) -> None:
        if self._ticker is not None:
            self._ticker.cancel()
            try:
                await self._ticker
            except asyncio.CancelledError:
                pass
            self._ticker = None

    async def _tick(self) -> None:
        """Periodic publisher work on ``interval_seconds`` — the knob the
        reference validates but never uses (its ticker is an empty
        placeholder loop, reference metrics.py:102-112); here it refreshes
        the uptime gauge so the knob is observable."""
        t0 = time.monotonic()
        while True:
            await asyncio.sleep(self.config.interval_seconds)
            if self._uptime is not None:
                self._uptime.set(time.monotonic() - t0)

    # -- update hooks ---------------------------------------------------------

    def update_counters(
        self, stream: str, frames: int = 0, detections: int = 0,
        active_tracks: Optional[int] = None,
    ) -> None:
        if not self._initialized:
            return
        if frames:
            self._frames.labels(stream=stream).inc(frames)
        if detections:
            self._detections.labels(stream=stream).inc(detections)
        if active_tracks is not None:
            self._active_tracks.labels(stream=stream).set(active_tracks)

    def update_temporal_metrics(
        self, stream: str, sequences: int = 0, buffer_size: Optional[int] = None,
        inference_seconds: Optional[float] = None,
    ) -> None:
        if not self._initialized:
            return
        if sequences:
            self._temporal_sequences.labels(stream=stream).inc(sequences)
        if buffer_size is not None:
            self._temporal_buffer.labels(stream=stream).set(buffer_size)
        if inference_seconds is not None:
            self._temporal_latency.labels(stream=stream).observe(inference_seconds)

    def observe_batch(self, batch_size: int, inference_seconds: float) -> None:
        if not self._initialized:
            return
        self._batch_size.observe(batch_size)
        self._device_latency.observe(inference_seconds)

    def record_shed(self, stream: str, frames: int = 1) -> None:
        """A frame dropped by the batcher's in-flight cap (never counted as
        a processed frame — shed must be visible, not disguised)."""
        if not self._initialized:
            return
        self._shed.labels(stream=stream).inc(frames)
