"""Async video stream with reconnection and FPS pacing.

Behavioral contract (reference ``video_stream.py:36-243``):

  * async context manager + ``frames()`` async generator of FramePackets
    with monotonically increasing frame ids;
  * blocking decode happens in a worker thread (``asyncio.to_thread``);
  * on read failure: retry with exponential backoff capped at 30 s, a full
    close-and-reopen after 3 consecutive failures, and a hard give-up after
    ``max_retries`` (None = retry forever);
  * ``warmup_seconds`` sleep after open (camera exposure settling);
  * FPS pacing: sleep ``1 / target_fps`` after each yielded frame.

Sources: ``synthetic://`` URLs map to the built-in generator; everything else
(file paths, rtsp/rtmp/http URLs) goes through ``cv2.VideoCapture`` with the
FFmpeg backend (H.265/HEVC capable).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import AsyncIterator

from ..config import StreamConfig
from ..types import FramePacket
from .synthetic import SyntheticSource

logger = logging.getLogger(__name__)

_BACKOFF_CAP_S = 30.0
_RECONNECT_AFTER_FAILURES = 3


class StreamSourceError(RuntimeError):
    """Raised when a stream source cannot be opened or permanently fails."""


def _open_capture(url: str, target_fps: float = 0.0, name: str = "?"):
    if url.startswith("synthetic://"):
        return SyntheticSource.from_url(url)
    try:
        import cv2
    except ImportError as exc:  # pragma: no cover
        raise StreamSourceError(
            f"cv2 is required for non-synthetic source '{url}'"
        ) from exc
    cap = cv2.VideoCapture(url, cv2.CAP_FFMPEG)
    if not cap.isOpened():
        # some builds need the default backend for plain files
        cap = cv2.VideoCapture(url)
    if cap.isOpened():
        # capture configuration (reference video_stream.py:97-142): request
        # the target rate, keep internal buffering minimal for low latency,
        # and log the negotiated codec/resolution so stream debugging
        # doesn't need ffprobe
        try:
            if target_fps and target_fps > 0:
                cap.set(cv2.CAP_PROP_FPS, float(target_fps))
        except Exception:  # pragma: no cover  # noqa: BLE001
            pass
        try:
            # low latency: must apply regardless of CAP_PROP_FPS outcome
            cap.set(cv2.CAP_PROP_BUFFERSIZE, 1)
        except Exception:  # pragma: no cover  # noqa: BLE001
            pass
        try:
            fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
            codec = (
                "".join(chr((fourcc >> (8 * i)) & 0xFF) for i in range(4)).strip()
                or "unknown"
            )
            w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
            h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
            fps = cap.get(cv2.CAP_PROP_FPS)
            logger.info(
                "Stream '%s': codec=%s %dx%d @ %.1f fps", name, codec, w, h, fps
            )
        except Exception:  # pragma: no cover  # noqa: BLE001
            pass
    return cap


class VideoStream:
    def __init__(self, config: StreamConfig):
        self.config = config
        self._capture = None
        self._frame_id = 0

    async def __aenter__(self) -> "VideoStream":
        await self.open()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.close()

    async def open(self) -> None:
        cap = await asyncio.to_thread(
            _open_capture, self.config.url, self.config.target_fps,
            self.config.name,
        )
        if cap is None or not cap.isOpened():
            raise StreamSourceError(
                f"Stream '{self.config.name}': cannot open url '{self.config.url}'"
            )
        self._capture = cap
        if self.config.warmup_seconds > 0:
            await asyncio.sleep(self.config.warmup_seconds)
        logger.info("Stream '%s' opened (%s)", self.config.name, self.config.url)

    async def close(self) -> None:
        if self._capture is not None:
            cap, self._capture = self._capture, None
            await asyncio.to_thread(cap.release)

    async def _reopen(self) -> None:
        await self.close()
        await self.open()

    async def frames(self) -> AsyncIterator[FramePacket]:
        """Yield FramePackets until the source permanently fails/ends."""
        cfg = self.config
        retries = 0
        consecutive_failures = 0
        pace = (1.0 / cfg.target_fps) if cfg.target_fps else 0.0
        opened_once = False
        cycle_start = time.perf_counter()
        while True:
            if self._capture is None:
                if not opened_once:
                    raise StreamSourceError(f"Stream '{cfg.name}' is not open")
                # a failed _reopen left us sourceless: that is a read
                # failure, not a terminal state — max_retries=None means
                # retry forever (module docstring), so fall through to the
                # same backoff/reconnect path instead of raising
                ok, frame = False, None
            else:
                opened_once = True
                if getattr(self._capture, "fast_read", False):
                    # pooled synthetic source: read() is a dict lookup —
                    # the to_thread hop would cost ~1-2 ms of executor
                    # scheduling per frame, dominating the loop on a busy
                    # host (cv2/ffmpeg reads DO block and keep the hop)
                    ok, frame = self._capture.read()
                    await asyncio.sleep(0)  # stay cooperative
                else:
                    ok, frame = await asyncio.to_thread(self._capture.read)
            if not ok or frame is None:
                retries += 1
                consecutive_failures += 1
                if cfg.max_retries is not None and retries > cfg.max_retries:
                    logger.error(
                        "Stream '%s': giving up after %d retries", cfg.name, retries
                    )
                    return
                backoff = min(
                    cfg.reconnect_backoff * (2 ** (consecutive_failures - 1)),
                    _BACKOFF_CAP_S,
                )
                logger.warning(
                    "Stream '%s': read failed (attempt %d), backing off %.1fs",
                    cfg.name, retries, backoff,
                )
                await asyncio.sleep(backoff)
                if consecutive_failures >= _RECONNECT_AFTER_FAILURES:
                    logger.info("Stream '%s': forcing reconnect", cfg.name)
                    try:
                        await self._reopen()
                        consecutive_failures = 0
                    except StreamSourceError as exc:
                        logger.warning(
                            "Stream '%s': reconnect failed: %s", cfg.name, exc
                        )
                continue
            consecutive_failures = 0
            retries = 0
            packet = FramePacket(
                stream=cfg,
                frame=frame,
                frame_id=self._frame_id,
                timestamp=time.time(),
            )
            self._frame_id += 1
            yield packet
            if pace > 0:
                # COMPENSATED relative pacing: sleep the interval MINUS the
                # time this iteration already spent reading/submitting, so
                # the stream self-clocks at target_fps without the work
                # time silently stretching every interval. Per-stream
                # self-clocking is a deliberate choice over an absolute
                # wire-clock schedule: when work time exceeds the interval
                # the sleep clamps at ~0 and the rate degrades smoothly
                # (consumer-time backpressure) instead of piling frames
                # into the batcher queue — measured at 32x25 offered on a
                # saturated 1-core host, a wire-clock schedule carried 781
                # fps but at p50 105-137 ms of pure queueing; a real
                # camera would shed those frames anyway
                # (docs/performance.md, round 5).
                now = time.perf_counter()
                await asyncio.sleep(max(0.001, pace - (now - cycle_start)))
            cycle_start = time.perf_counter()
