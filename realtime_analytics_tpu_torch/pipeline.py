"""Pipeline orchestration: stream workers, scheduler, health, lifecycle.

The port's copy of the JAX package's ``pipeline.py``, temporal branches
included: a temporal engine's clip buffer is reset on reconnect, and its
per-stream metrics are published.

Architecture (vs reference ``pipeline.py``): the reference runs one asyncio
task per stream and calls ``detector.predict`` *synchronously inside the
event loop* (pipeline.py:179) — under load, 32 streams serialize behind one
another. Here workers stay host-side and awaitable end to end:

    VideoStream.frames() -> host filters (ROI mask / downsample / motion /
    adaptive skip) -> InferenceBatcher.submit() [await] -> rescale ->
    confidence filter -> IouTracker.update -> metrics -> sinks -> snapshot

One batcher per detector-id packs frames from all streams sharing that
detector into single device batches.

Reference fixes carried into this design (SURVEY.md "quirks to fix"):
  * ``StreamScheduler.recommend_adaptive_adjustment`` actually drives worker
    frame-skipping (dead code at reference pipeline.py:379-406);
  * snapshot dir/interval configurable (reference hardcodes /data/outputs
    and 300 s at pipeline.py:269,282);
  * stream priority configurable (reference hardcodes 0 at pipeline.py:494).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import signal
import time
from collections import deque
from pathlib import Path
from typing import Deque, Dict, List, Optional

import numpy as np

from .config import PipelineConfig, StreamConfig
from .engine.batcher import InferenceBatcher
from .engine.detector import BaseDetector, create_detector
from .engine.temporal import TorchTemporalEngine
from .ingest.ffmpeg_simulator import FFmpegStreamSimulator
from .ingest.video_stream import StreamSourceError, VideoStream
from .sinks.kafka_sink import KafkaSink
from .telemetry import spans
from .telemetry.metrics import MetricsPublisher
from .tracker import IouTracker
from .types import Detection, FramePacket, filter_detections
from .utils.frame_filter import MotionFilter, MotionFilterConfig, roi_mask

logger = logging.getLogger(__name__)

DEFAULT_DETECTOR_ID = "__default__"


def _stream_source_hw(url: str):
    """(H, W) of a stream when statically knowable (synthetic:// encodes
    it); None for file/RTSP sources whose resolution arrives with frame 1."""
    if not url.startswith("synthetic://"):
        return None
    from urllib.parse import parse_qs, urlparse

    q = parse_qs(urlparse(url).query)

    def geti(name, default):
        return int(q[name][0]) if name in q else default

    return (geti("height", 480), geti("width", 640))


# ---------------------------------------------------------------------------
# Health / scheduling
# ---------------------------------------------------------------------------


class StreamHealth:
    """Rolling per-stream health (reference pipeline.py:38-74)."""

    def __init__(self, name: str, priority: int = 0):
        self.name = name
        self.priority = priority
        self.last_success_ts: float = 0.0
        self.first_success_ts: float = 0.0
        self.consecutive_errors: int = 0
        self.total_frames: int = 0
        self.recent_processing_times: Deque[float] = deque(maxlen=100)
        self.recent_success_ts: Deque[float] = deque(maxlen=50)

    def update_success(self, processing_time_s: float) -> None:
        self.last_success_ts = time.time()
        if self.first_success_ts == 0.0:
            self.first_success_ts = self.last_success_ts
        self.consecutive_errors = 0
        self.total_frames += 1
        self.recent_processing_times.append(processing_time_s)
        self.recent_success_ts.append(self.last_success_ts)

    @property
    def effective_fps(self) -> float:
        """Processed frames/s over the recent success window."""
        ts = self.recent_success_ts
        if len(ts) < 2:
            return 0.0
        span = ts[-1] - ts[0]
        return (len(ts) - 1) / span if span > 0 else 0.0

    def update_error(self) -> None:
        self.consecutive_errors += 1

    @property
    def avg_processing_time(self) -> float:
        if not self.recent_processing_times:
            return 0.0
        return sum(self.recent_processing_times) / len(self.recent_processing_times)

    @property
    def health_score(self) -> float:
        error_penalty = 1.0 / (1.0 + self.consecutive_errors)
        if self.last_success_ts == 0.0:
            recency = 0.5  # never succeeded yet
        else:
            age = time.time() - self.last_success_ts
            recency = max(0.0, 1.0 - age / 60.0)
        return error_penalty * recency


class StreamScheduler:
    """Advisory scheduler: priority ranking + load-based adaptive hints
    (reference pipeline.py:293-437 — except the hints are consumed here)."""

    TARGET_FRAME_TIME_S = 0.033  # ~30 FPS SLO (reference pipeline.py:374-375)

    def __init__(self) -> None:
        self._health: Dict[str, StreamHealth] = {}
        self._load_window: Deque[float] = deque(maxlen=60)

    def register(self, health: StreamHealth) -> None:
        self._health[health.name] = health

    def record_processing_time(self, seconds: float) -> None:
        self._load_window.append(seconds)

    def get_system_load_factor(self) -> float:
        if not self._load_window:
            return 0.0
        avg = sum(self._load_window) / len(self._load_window)
        return avg / self.TARGET_FRAME_TIME_S

    def priority_score(self, name: str) -> float:
        h = self._health.get(name)
        if h is None:
            return 0.0
        processing_penalty = min(
            2.0, h.avg_processing_time / self.TARGET_FRAME_TIME_S
        )
        return 10.0 * h.priority + 5.0 * h.health_score - 2.0 * processing_penalty

    def recommend_adaptive_adjustment(self, name: str) -> Optional[str]:
        """"decrease" = shed load (skip more frames), "increase" = recover."""
        load = self.get_system_load_factor()
        h = self._health.get(name)
        if h is None:
            return None
        if load > 1.5 or h.consecutive_errors > 3:
            return "decrease"
        if load < 0.5 and h.health_score > 0.8:
            return "increase"
        return None

    def status_lines(self, top_n: int = 5) -> List[str]:
        ranked = sorted(
            self._health.values(),
            key=lambda h: self.priority_score(h.name),
            reverse=True,
        )
        lines = [
            f"system load factor: {self.get_system_load_factor():.2f} "
            f"({len(self._health)} streams)"
        ]
        for h in ranked[:top_n]:
            lines.append(
                f"  {h.name}: score={self.priority_score(h.name):.2f} "
                f"health={h.health_score:.2f} frames={h.total_frames} "
                f"avg_ms={h.avg_processing_time * 1e3:.1f} "
                f"errors={h.consecutive_errors}"
            )
        return lines


# ---------------------------------------------------------------------------
# Stream worker
# ---------------------------------------------------------------------------


class StreamWorker:
    def __init__(
        self,
        stream: StreamConfig,
        batcher: InferenceBatcher,
        detector: BaseDetector,
        tracker: IouTracker,
        kafka: KafkaSink,
        metrics: MetricsPublisher,
        health: StreamHealth,
        scheduler: StreamScheduler,
        pipeline_config: PipelineConfig,
    ):
        self.stream = stream
        self.batcher = batcher
        self.detector = detector
        self.tracker = tracker
        self.kafka = kafka
        self.metrics = metrics
        self.health = health
        self.scheduler = scheduler
        self.pconfig = pipeline_config
        self._stop = asyncio.Event()
        self._pending: Deque = deque()  # (packet, t_start, inference task)
        # eager completion (round 3): a dedicated completer coroutine
        # finishes frames the moment their batcher future resolves, in
        # strict frame order. The previous design completed lazily from the
        # NEXT frame's _process_packet call, which deferred every
        # completion (tracker update, kafka publish, latency stamp) by one
        # frame interval — at 25 FPS that put a constant +40 ms on every
        # frame's end-to-end latency (measured: p50 43 ms of which ~31 ms
        # was pure deferral; the SLO is 40).
        self._pending_event = asyncio.Event()
        self._completer: Optional[asyncio.Task] = None
        self._slots = asyncio.Semaphore(max(1, stream.batch_size))
        self._roi_mask: Optional[np.ndarray] = None
        self._motion = (
            MotionFilter(
                MotionFilterConfig(enable=True, threshold=stream.motion_threshold)
            )
            if stream.motion_filter
            else None
        )
        # adaptive frame skipping state (reference pipeline.py:107-116,242-262)
        self._process_every = 1
        self._idle_frames = 0
        self._frame_counter = 0
        self._track_ema_ms = 0.0  # recent tracker-update cost (see _tracker_update)
        self._last_snapshot_ts = 0.0
        self._max_process_every = max(
            1,
            round(
                (stream.target_fps or 30.0) / max(stream.min_target_fps, 0.001)
            ),
        ) if stream.adaptive_fps else 1

    def request_stop(self) -> None:
        self._stop.set()

    async def run(self) -> None:
        cfg = self.stream
        self._completer = asyncio.create_task(
            self._completion_loop(), name=f"complete-{cfg.name}"
        )
        try:
            while not self._stop.is_set():
                try:
                    async with VideoStream(cfg) as vs:
                        async for packet in vs.frames():
                            if self._stop.is_set():
                                await self._drain_pending()
                                return
                            await self._process_packet(packet)
                        await self._drain_pending()
                    # generator ended: source exhausted (file) or gave up
                    logger.info("Stream '%s': source ended", cfg.name)
                    if cfg.max_retries is not None:
                        return
                except StreamSourceError as exc:
                    logger.warning("Stream '%s': %s", cfg.name, exc)
                    self.health.update_error()
                except asyncio.CancelledError:
                    return
                except Exception:  # noqa: BLE001
                    logger.exception("Stream '%s': worker error", cfg.name)
                    self.health.update_error()
                if self._stop.is_set():
                    return
                # stream state must not straddle a reconnect
                if isinstance(self.detector, TorchTemporalEngine):
                    self.detector.reset_stream(cfg.name)
                if self._motion is not None:
                    self._motion.reset()
                await asyncio.sleep(cfg.reconnect_backoff)
        finally:
            # drain may itself be interrupted by cancellation (pipeline
            # stop) — the completer must still be reaped or it leaks past
            # pipeline.stop() (it is not in pipeline._tasks)
            try:
                await self._drain_pending()
            finally:
                if self._completer is not None:
                    self._completer.cancel()
                    with contextlib.suppress(asyncio.CancelledError):
                        await self._completer
                    self._completer = None

    async def _completion_loop(self) -> None:
        """Consume pending frames FIFO, finishing each the instant its
        inference future resolves — never waiting for the next frame tick.
        A single consumer per stream preserves the tracker's frame-order
        requirement; the semaphore it releases paces the read loop."""
        while True:
            if not self._pending:
                self._pending_event.clear()
                await self._pending_event.wait()
                continue
            try:
                await self._complete_oldest()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — a sink/tracker crash must
                # not silently wedge the stream (slots would leak)
                logger.exception(
                    "Stream '%s': completion failed", self.stream.name
                )
            finally:
                self._slots.release()

    async def _process_packet(self, packet: FramePacket) -> None:
        """Host-side filters, then *pipelined* submit: up to
        ``stream.batch_size`` frames may be awaiting inference while the next
        frame is being decoded/filtered; completions are handled strictly in
        frame order (the tracker requires it)."""
        cfg = self.stream
        t_start = time.perf_counter()
        frame = packet.frame

        # ROI masking (precomputed mask — reference rasterizes per frame)
        if cfg.roi_polygons:
            if self._roi_mask is None or self._roi_mask.shape != frame.shape[:2]:
                self._roi_mask = roi_mask(frame.shape[:2], cfg.roi_polygons)
            frame = frame * self._roi_mask[..., None]

        ratio = cfg.downsample_ratio
        if ratio < 0.999:
            from .utils.frame_filter import downsample

            frame = downsample(frame, ratio)

        if self._motion is not None and not self._motion.should_process(frame):
            # skips join the ordered pending queue (marker: no infer packet):
            # a skipped frame must not age tracks before an earlier
            # in-flight frame's detections land
            await self._enqueue(packet, t_start, None)
            return

        # adaptive frame skipping
        self._frame_counter += 1
        if self._process_every > 1 and (
            self._frame_counter % self._process_every != 0
        ):
            await self._enqueue(packet, t_start, None)
            return

        infer_packet = (
            packet
            if frame is packet.frame
            else FramePacket(cfg, np.ascontiguousarray(frame), packet.frame_id,
                             packet.timestamp)
        )
        await self._enqueue(packet, t_start, infer_packet)

    async def _enqueue(self, packet: FramePacket, t_start: float,
                       infer_packet: Optional[FramePacket]) -> None:
        """Hand a frame (or an ordered skip marker, infer_packet=None) to
        the completer. The semaphore bounds this stream's in-flight frames
        at ``batch_size`` — acquiring it is what paces the read loop when
        the device falls behind (the pre-round-3 ``while len(pending) >=
        max_inflight`` loop, without the completion-deferral side effect).
        The slot is taken BEFORE the batcher submit: the batcher's own
        per-stream cap counts live submits, and an early submit from a
        blocked worker would be shed as overflow."""
        await self._slots.acquire()
        # submit_nowait returns the result future directly — no per-frame
        # Task wrapper (measurable event-loop load at 800 frames/s)
        task = (
            self.batcher.submit_nowait(infer_packet)
            if infer_packet is not None else None
        )
        self._pending.append((packet, t_start, task))
        self._pending_event.set()

    async def _drain_pending(self) -> None:
        while self._pending:
            await asyncio.sleep(0.005)

    async def _complete_oldest(self) -> None:
        packet, t_start, task = self._pending.popleft()
        if task is None:  # ordered skip marker (motion/adaptive)
            await self._skip_frame(packet)
            return
        try:
            detections = await task
        except RuntimeError:
            self.health.update_error()
            return
        if detections is None:
            # shed by the batcher (in-flight cap / shutdown): a dropped frame
            # must look like a skip — age tracks, no sink event, no health
            # success — not like a clean zero-detection result
            await self._skip_frame(packet)
            return
        with spans.completing(self.stream.name, packet.frame_id, t_start):
            await self._finish_packet(packet, t_start, detections)

    async def _finish_packet(
        self, packet: FramePacket, t_start: float, detections: List[Detection]
    ) -> None:
        cfg = self.stream
        ratio = cfg.downsample_ratio
        if ratio < 0.999 and detections:
            inv = 1.0 / ratio
            detections = [
                Detection(
                    d.stream_name, d.frame_id, d.class_id, d.confidence,
                    tuple(v * inv for v in d.bbox_xyxy),
                )
                for d in detections
            ]
        if hasattr(self.detector, "config"):
            detections = filter_detections(
                detections, self.detector.config.confidence_threshold
            )

        with spans.span("tracker"):
            tracks = await self._tracker_update(detections)
        self.metrics.update_counters(
            cfg.name,
            frames=1,
            detections=len(detections),
            active_tracks=len(tracks),
        )
        if isinstance(self.detector, TorchTemporalEngine):
            self.metrics.update_temporal_metrics(
                cfg.name,
                sequences=1 if detections else 0,
                buffer_size=self.detector.buffered(cfg.name),
                inference_seconds=self.detector.last_infer_ms / 1e3
                if detections else None,
            )
        with spans.span("sink"):
            await self.kafka.send_tracks(
                cfg.name, packet.frame_id, tracks, packet.frame,
                health=self.health.health_score, fps=self.health.effective_fps,
            )
        if self._snapshot_due():
            # draw + JPEG encode + disk write off the event loop: done
            # inline it would stall every stream's completions for the
            # encode/write duration (~tens of ms, worse on slow disks)
            await asyncio.to_thread(self._save_snapshot, packet, tracks)
        self._adjust_adaptive_state(len(detections), len(tracks))

        elapsed = time.perf_counter() - t_start
        self.health.update_success(elapsed)
        self.scheduler.record_processing_time(elapsed)

    async def _tracker_update(self, detections: List[Detection]):
        """Associate detections, inline or on an executor thread.

        The IOU-shim update on a typical scene is ~0.1 ms of small-array
        numpy — the ``to_thread`` dispatch (context copy + executor submit +
        threadsafe wakeup) costs MORE than that and adds queue latency under
        load, so cheap updates run inline. A slow tracker (byte_track_full
        Hungarian/Kalman on crowded scenes) would stall every stream's
        completions if inlined, so updates whose recent EMA exceeds 1 ms
        auto-offload to the executor (per-stream tracker states stay
        independent either way — the tracker locks per stream)."""
        name = self.stream.name
        if not detections:
            # empty updates only age tracks (no association) — always cheap,
            # always inline, and excluded from the EMA: skip-frames would
            # otherwise decay it below the gate between crowded frames and
            # periodically let a slow full update stall the loop
            return self.tracker.update(name, detections)
        t0 = time.perf_counter()
        if self._track_ema_ms < 1.0:
            tracks = self.tracker.update(name, detections)
        else:
            tracks = await asyncio.to_thread(self.tracker.update, name, detections)
        dt_ms = (time.perf_counter() - t0) * 1e3
        self._track_ema_ms += 0.1 * (dt_ms - self._track_ema_ms)
        return tracks

    async def _skip_frame(self, packet: FramePacket) -> None:
        """Skipped frames still age tracks, tick metrics, and tick adaptive
        idle state (reference pipeline.py:214-222)."""
        tracks = await self._tracker_update([])
        self.metrics.update_counters(
            self.stream.name, frames=1, detections=0, active_tracks=len(tracks)
        )
        self._adjust_adaptive_state(0, len(tracks))

    def _adjust_adaptive_state(self, num_detections: int, num_tracks: int = 0) -> None:
        """Reference contract (pipeline.py:242-262): full rate while
        detections OR live tracks exist; idle ticks on skips too."""
        cfg = self.stream
        if num_detections > 0 or num_tracks > 0:
            self._idle_frames = 0
            self._process_every = 1
            return
        self._idle_frames += 1
        if not cfg.adaptive_fps:
            return
        if self._idle_frames >= cfg.idle_frame_tolerance:
            self._process_every = self._max_process_every
        # scheduler hint (live wiring of the reference's dead recommend API)
        hint = self.scheduler.recommend_adaptive_adjustment(cfg.name)
        if hint == "decrease":
            self._process_every = min(
                self._max_process_every, max(2, self._process_every * 2)
            )
        elif hint == "increase" and self._idle_frames < cfg.idle_frame_tolerance:
            self._process_every = 1

    def _snapshot_due(self) -> bool:
        snaps = self.pconfig.snapshots
        if not snaps.enabled:
            return False
        now = time.time()
        if now - self._last_snapshot_ts < snaps.interval_seconds:
            return False
        self._last_snapshot_ts = now
        return True

    def _save_snapshot(self, packet: FramePacket, tracks) -> None:
        snaps = self.pconfig.snapshots
        now = time.time()
        try:
            import cv2

            out_dir = Path(snaps.output_dir) / self.stream.name
            out_dir.mkdir(parents=True, exist_ok=True)
            img = packet.frame.copy()
            for t in tracks:
                x1, y1, x2, y2 = (int(v) for v in t.bbox_xyxy)
                cv2.rectangle(img, (x1, y1), (x2, y2), (0, 220, 0), 2)
                cv2.putText(
                    img, f"ID {t.track_id} c{t.class_id}", (x1, max(12, y1 - 4)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, (0, 220, 0), 1, cv2.LINE_AA,
                )
            name = f"{int(now)}_frame{packet.frame_id}.jpg"
            cv2.imwrite(str(out_dir / name), img)
        except ImportError:
            pass
        except Exception:  # noqa: BLE001
            logger.exception("snapshot failed for '%s'", self.stream.name)


# ---------------------------------------------------------------------------
# Pipeline
# ---------------------------------------------------------------------------


class AnalyticsPipeline:
    def __init__(self, config: PipelineConfig):
        config.validate()
        self.config = config
        from .bytetrack import create_tracker

        self.tracker = create_tracker(config.tracker)
        self.kafka = KafkaSink(config.kafka)
        self.metrics = MetricsPublisher(config.prometheus)
        self.scheduler = StreamScheduler()
        self.detectors: Dict[str, BaseDetector] = {}
        self.batchers: Dict[str, InferenceBatcher] = {}
        self.workers: List[StreamWorker] = []
        self._tasks: List[asyncio.Task] = []
        self._simulators: List[FFmpegStreamSimulator] = []
        self._stop_event = asyncio.Event()
        self._started = False

    # -- lifecycle ------------------------------------------------------------

    async def start(self) -> None:
        cfg = self.config
        await self.metrics.start()
        await self.kafka.connect()
        self._start_ffmpeg_simulators()

        # detectors: default + named (reference pipeline.py:470-475). The
        # default is skipped when no enabled stream routes to it (every
        # stream names a VALID detector_id) — constructing it anyway would
        # load a model and warm-compile every bucket for an engine no
        # stream uses (tens of seconds of startup + resident HBM).
        default_needed = not cfg.streams or any(
            s.enabled and (not s.detector_id or s.detector_id not in cfg.detectors)
            for s in cfg.streams
        )
        if default_needed:
            self.detectors[DEFAULT_DETECTOR_ID] = create_detector(cfg.detector)
        for det_id, det_cfg in cfg.detectors.items():
            self.detectors[det_id] = create_detector(det_cfg)

        await self._warmup_detectors()

        # one batcher per detector id
        for det_id, det in self.detectors.items():
            batcher = InferenceBatcher(
                det,
                max_batch=getattr(det.config, "max_batch_size", 32),
                batch_window_ms=cfg.batch_window_ms,
                pipeline_depth=cfg.batch_pipeline_depth,
                metrics=self.metrics,
                temporal_clip_window_ms=cfg.temporal_clip_window_ms,
            )
            await batcher.start()
            self.batchers[det_id] = batcher

        enabled = [s for s in cfg.streams if s.enabled]
        for stream in enabled:
            det_id = stream.detector_id or DEFAULT_DETECTOR_ID
            if det_id not in self.detectors:
                logger.warning(
                    "Stream '%s': unknown detector_id '%s', using default",
                    stream.name, det_id,
                )
                det_id = DEFAULT_DETECTOR_ID
            health = StreamHealth(stream.name, priority=stream.priority)
            self.scheduler.register(health)
            worker = StreamWorker(
                stream=stream,
                batcher=self.batchers[det_id],
                detector=self.detectors[det_id],
                tracker=self.tracker,
                kafka=self.kafka,
                metrics=self.metrics,
                health=health,
                scheduler=self.scheduler,
                pipeline_config=cfg,
            )
            self.workers.append(worker)
            self._tasks.append(
                asyncio.create_task(worker.run(), name=f"stream-{stream.name}")
            )
        self._tasks.append(
            asyncio.create_task(self._monitor_scheduler(), name="scheduler-monitor")
        )
        self._started = True
        logger.info("Pipeline started with %d streams", len(enabled))

    async def _warmup_detectors(self) -> None:
        """Pre-compile the fused step per (bucket, source resolution) when
        ``detector.warmup`` is true — the analog of the reference's
        dummy-tensor warmup (detector.py:131-140). Without this, a
        production start stalls on first-batch compiles."""
        cfg = self.config
        # detector id -> source resolutions of the streams that feed it
        feeds: Dict[str, set] = {det_id: set() for det_id in self.detectors}
        for stream in cfg.streams:
            if not stream.enabled:
                continue
            det_id = stream.detector_id or DEFAULT_DETECTOR_ID
            if det_id not in self.detectors:
                det_id = DEFAULT_DETECTOR_ID
            hw = _stream_source_hw(stream.url)
            if hw is not None:
                feeds[det_id].add(hw)
        for det_id, det in self.detectors.items():
            dcfg = getattr(det, "config", None)
            if dcfg is None or not getattr(dcfg, "warmup", False):
                continue
            if not hasattr(det, "warmup"):
                continue
            hws = feeds.get(det_id) or set()
            if not hws:
                fallback = getattr(dcfg, "warmup_source_hw", None) or [1080, 1920]
                hws = {tuple(fallback)}
            for hw in sorted(hws):
                if self._stop_event.is_set():
                    # SIGTERM during startup: each warmup compile is
                    # uninterruptible, but don't start the NEXT one —
                    # shutdown latency stays one compile, not all of them
                    logger.info("stop requested — skipping remaining warmup")
                    return
                t0 = time.perf_counter()
                await asyncio.to_thread(det.warmup, hw)
                logger.info(
                    "detector '%s' warmed up for src=%s in %.1fs",
                    det_id, hw, time.perf_counter() - t0,
                )

    async def stop(self) -> None:
        self._stop_event.set()
        for w in self.workers:
            w.request_stop()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()
        for batcher in self.batchers.values():
            await batcher.stop()
        await self.kafka.close()
        await self.metrics.stop()
        self._stop_ffmpeg_simulators()
        logger.info("Pipeline stopped")

    async def run_forever(self) -> None:
        # handlers BEFORE the (slow: model load + warmup) start so a signal
        # during startup still means graceful stop, not default kill
        self._install_signal_handlers()
        await self.start()
        try:
            # wait for stop OR all stream workers finishing (finite sources)
            stream_tasks = [t for t in self._tasks if t.get_name().startswith("stream-")]
            stop_wait = asyncio.create_task(self._stop_event.wait())
            # gather() returns a Future, not a coroutine — create_task would
            # raise TypeError; ensure_future passes it through
            done = asyncio.ensure_future(
                asyncio.gather(*stream_tasks, return_exceptions=True)
            )
            await asyncio.wait({stop_wait, done}, return_when=asyncio.FIRST_COMPLETED)
        finally:
            stop_wait.cancel()
            await self._graceful_shutdown(done)

    async def run_for(self, seconds: float) -> None:
        """Run the pipeline until all stream workers finish (finite sources),
        ``seconds`` elapse, or SIGINT/SIGTERM arrives, whichever comes first.
        Signals stop a bounded run gracefully too — a supervised shard
        (`--shards` + `--duration`) must exit rc=0 on SIGTERM, exactly like
        the reference's signal path (reference pipeline.py:553-560)."""
        self._install_signal_handlers()
        await self.start()
        stream_tasks = [
            t for t in self._tasks if t.get_name().startswith("stream-")
        ]
        stop_wait = asyncio.create_task(self._stop_event.wait())
        # gather() returns a Future, not a coroutine — create_task would
        # raise TypeError; ensure_future passes it through
        done = asyncio.ensure_future(
            asyncio.gather(*stream_tasks, return_exceptions=True)
        )
        try:
            await asyncio.wait(
                {stop_wait, done},
                timeout=seconds,
                return_when=asyncio.FIRST_COMPLETED,
            )
        finally:
            stop_wait.cancel()
            await self._graceful_shutdown(done)

    # -- internals ------------------------------------------------------------

    async def _graceful_shutdown(self, done: asyncio.Future) -> None:
        """Signal workers and give them a short window to drain their
        pending frames before stop() cancels whatever remains. Cancelling
        the gather directly would deliver a FIRST CancelledError (worker
        enters its drain), then stop()'s t.cancel() a SECOND one that
        aborts the drain mid-flush — dropping up to batch_size in-flight
        frames per stream on every shutdown."""
        for w in self.workers:
            w.request_stop()
        with contextlib.suppress(asyncio.TimeoutError):
            await asyncio.wait_for(asyncio.shield(done), timeout=5.0)
        await self.stop()  # cancels any leftover task exactly once
        with contextlib.suppress(asyncio.CancelledError):
            await done

    def _install_signal_handlers(self) -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self._stop_event.set)
            except NotImplementedError:  # pragma: no cover (windows)
                pass

    async def _monitor_scheduler(self) -> None:
        interval = self.config.stats_interval_seconds
        while not self._stop_event.is_set():
            await asyncio.sleep(interval)
            for line in self.scheduler.status_lines():
                logger.info("[scheduler] %s", line)
            stats = {
                det_id: b.stats.snapshot() for det_id, b in self.batchers.items()
            }
            logger.info("[batcher] %s", stats)

    def _start_ffmpeg_simulators(self) -> None:
        for stream in self.config.streams:
            sim_cfg = stream.ffmpeg_simulator
            if stream.enabled and sim_cfg and sim_cfg.enabled:
                sim = FFmpegStreamSimulator(stream, sim_cfg)
                sim.start()
                self._simulators.append(sim)

    def _stop_ffmpeg_simulators(self) -> None:
        for sim in self._simulators:
            try:
                sim.stop()
            except Exception:  # noqa: BLE001
                logger.exception("failed to stop ffmpeg simulator")
        self._simulators.clear()


def run_from_config(path: str) -> None:
    """CLI entry: load YAML, run pipeline until signalled."""
    from .config import load_config

    config = load_config(path)
    pipeline = AnalyticsPipeline(config)
    asyncio.run(pipeline.run_forever())
