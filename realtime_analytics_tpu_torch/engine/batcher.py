"""Cross-stream dynamic batcher — the core win over the reference.

The reference claims "Detector-level batching across streams"
(pipeline.py:7) but actually calls ``detector.predict`` synchronously with
batch 1, per frame, per stream (pipeline.py:179; ``StreamConfig.batch_size``
is validated and then dead — SURVEY.md §2.15). That design blocks the event
loop and leaves the accelerator idle between frames.

Here every stream worker submits frames to one ``InferenceBatcher`` and
awaits a future. A single device loop:

  1. waits for the first queued frame,
  2. drains whatever else arrives within ``batch_window_ms`` (or until
     ``max_batch`` frames are queued),
  3. groups frames by source resolution, packs each group into the smallest
     compile bucket, runs the engine's fused jit step in a worker thread
     (device compute releases the GIL), and
  4. resolves each stream's future with its slice of the padded results.

Per-stream ``batch_size`` caps a stream's in-flight frames — a slow consumer
cannot monopolize device batches.

Pipelining: up to ``pipeline_depth`` batches are in flight at once, so the
host->device transfer and host pick of batch i+1 overlap the device compute
of batch i. Ordering safety: frames of a stream that already has a batch in
flight are deferred to the next batch, so a stream's frames can never be
processed out of order (the tracker requires per-stream frame order).
"""

from __future__ import annotations

import asyncio
import logging
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

from ..telemetry import spans
from ..types import Detection, FramePacket

logger = logging.getLogger(__name__)


class BatcherStats:
    __slots__ = (
        "batches", "frames", "sum_batch_size", "max_batch_size", "sum_infer_ms",
        "sum_wait_ms", "shed", "clip_batches", "clips", "sum_clip_batch_size",
    )

    def __init__(self) -> None:
        self.batches = 0
        self.frames = 0
        self.sum_batch_size = 0
        self.max_batch_size = 0
        self.sum_infer_ms = 0.0
        self.sum_wait_ms = 0.0
        self.shed = 0  # frames dropped by the per-stream in-flight cap
        self.clip_batches = 0  # temporal clip-coalescing device calls
        self.clips = 0
        self.sum_clip_batch_size = 0

    @property
    def avg_batch_size(self) -> float:
        return self.sum_batch_size / self.batches if self.batches else 0.0

    @property
    def avg_infer_ms(self) -> float:
        return self.sum_infer_ms / self.batches if self.batches else 0.0

    def snapshot(self) -> dict:
        out = {
            "batches": self.batches,
            "frames": self.frames,
            "avg_batch_size": round(self.avg_batch_size, 2),
            "max_batch_size": self.max_batch_size,
            "avg_infer_ms": round(self.avg_infer_ms, 2),
            "avg_wait_ms": round(self.sum_wait_ms / max(self.frames, 1), 2),
            "shed": self.shed,
        }
        if self.clip_batches:
            out["clip_batches"] = self.clip_batches
            out["clips"] = self.clips
            out["avg_clip_batch_size"] = round(
                self.sum_clip_batch_size / self.clip_batches, 2
            )
        return out


class InferenceBatcher:
    """Packs frames from many streams into device batches."""

    def __init__(
        self,
        engine,
        *,
        max_batch: int = 32,
        batch_window_ms: float = 4.0,
        per_stream_inflight: Optional[Dict[str, int]] = None,
        pipeline_depth: int = 2,
        metrics=None,
        temporal_clip_window_ms: float = 0.0,
    ):
        self.engine = engine
        self.metrics = metrics  # optional MetricsPublisher (observe_batch)
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        self.pipeline_depth = max(1, pipeline_depth)
        self._queue: asyncio.Queue = asyncio.Queue()
        self._deferred: list = []  # frames held back for stream-order safety
        self._busy_streams: set = set()
        self._running: set = set()  # in-flight batch tasks
        self._inflight: Dict[str, int] = defaultdict(int)
        self._inflight_cap = per_stream_inflight or {}
        self._task: Optional[asyncio.Task] = None
        self._closed = False
        self.stats = BatcherStats()
        # temporal clip coalescing: with a window > 0 and a temporal engine
        # (duck-typed: buffer_packet + predict_clips), frame buffering runs
        # inline per tick and ready clips are held up to the window so clips
        # from streams whose frames arrived in *different* ticks still run
        # as one device clip batch (clips cost 8-30x a single-frame detect —
        # see docs/TEMPORAL cost table — so batching them matters most).
        self.clip_window_s = max(0.0, temporal_clip_window_ms) / 1e3
        self._temporal = hasattr(engine, "buffer_packet") and hasattr(
            engine, "predict_clips"
        )
        self._pending_clips: list = []  # (sequence, future, t_submit)
        self._clip_timer: Optional[asyncio.Task] = None

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(), name="inference-batcher")

    async def stop(self) -> None:
        self._closed = True
        if self._task is not None:
            self._queue.put_nowait(None)  # wake the loop
            try:
                await asyncio.wait_for(self._task, timeout=5.0)
            except asyncio.TimeoutError:  # pragma: no cover
                # an in-flight device call (e.g. a first-batch compile) can't
                # be interrupted; abandon it rather than blocking shutdown —
                # but every unresolved future must still resolve (as shed)
                # or its awaiting submit() caller hangs forever
                self._task.cancel()
                for t in list(self._running):
                    t.cancel()
                self._drain_unserved()
            self._task = None

    def submit_nowait(self, packet: FramePacket) -> "asyncio.Future":
        """Synchronous submit: returns the frame's result future without a
        coroutine/Task wrapper — at 800 frames/s the per-frame Task object
        and its scheduling hop are measurable event-loop load (bench.py
        section 2 profile). The future resolves with the detections, or
        ``None`` when the frame is *shed* (per-stream in-flight cap hit, or
        batcher closed): the caller must treat that as a skip — age tracks,
        no sink event, no health success — never as a clean zero-detection
        result."""
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        if self._closed:
            fut.set_result(None)
            return fut
        name = packet.stream.name
        cap = self._inflight_cap.get(name, packet.stream.batch_size or 1)
        if self._inflight[name] >= max(1, cap):
            self.stats.shed += 1
            if self.metrics is not None:
                self.metrics.record_shed(name)
            fut.set_result(None)
            return fut
        self._inflight[name] += 1
        # decrement when the result lands (done callbacks run even when the
        # awaiting caller was cancelled — the old await-wrapper decremented
        # in its finally, which a cancelled caller also reached)
        fut.add_done_callback(lambda _f, name=name: self._dec_inflight(name))
        self._queue.put_nowait((packet, fut, time.perf_counter()))
        return fut

    def _dec_inflight(self, name: str) -> None:
        self._inflight[name] -= 1

    async def submit(self, packet: FramePacket) -> Optional[List[Detection]]:
        """Submit one frame and await its detections (see submit_nowait)."""
        return await self.submit_nowait(packet)

    # ------------------------------------------------------------------

    async def _run(self) -> None:
        while not self._closed:
            items = await self._collect_batch()
            if not items:
                # only deferred frames remain and their streams are busy:
                # wait for an in-flight batch instead of spinning
                if self._running:
                    await asyncio.wait(
                        self._running, return_when=asyncio.FIRST_COMPLETED
                    )
                continue
            # cap in-flight batches; wait for a slot
            while len(self._running) >= self.pipeline_depth:
                await asyncio.wait(self._running, return_when=asyncio.FIRST_COMPLETED)
            streams = {it[0].stream.name for it in items}
            self._busy_streams |= streams
            task = asyncio.create_task(self._process(items))
            self._running.add(task)

            def _done(t, streams=streams):
                self._running.discard(t)
                self._busy_streams -= streams

            task.add_done_callback(_done)
        if self._running:
            await asyncio.wait(self._running)
        self._drain_unserved()

    def _drain_unserved(self) -> None:
        """Resolve every unserved frame/clip future as shed (None) — never
        as a clean zero-detection result, and never left pending (an
        unresolved future wedges its awaiting submit() caller). Called from
        _run's shutdown tail and from stop()'s abandon-timeout path."""
        if self._clip_timer is not None:
            self._clip_timer.cancel()
            self._clip_timer = None
        for _, fut, _ in self._pending_clips:
            if not fut.done():
                fut.set_result(None)
        self._pending_clips.clear()
        for item in self._deferred:
            if not item[1].done():
                item[1].set_result(None)
        self._deferred.clear()
        while not self._queue.empty():
            item = self._queue.get_nowait()
            if item is not None and not item[1].done():
                item[1].set_result(None)

    async def _collect_batch(self) -> list:
        """Gather up to max_batch frames, deferring streams that already have
        a batch in flight (per-stream ordering guarantee)."""
        items: list = []
        # deferred frames (streams that were busy last round) go first
        still_deferred = []
        for it in self._deferred:
            if (
                len(items) < self.max_batch
                and it[0].stream.name not in self._busy_streams
            ):
                items.append(it)
            else:
                still_deferred.append(it)
        self._deferred = still_deferred

        if not items and not self._deferred:
            first = await self._queue.get()
            if first is None:
                self._closed = True
                return items
            self._sort_item(items, first)
        deadline = time.perf_counter() + self.batch_window_s
        while len(items) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                try:
                    nxt = self._queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
            else:
                try:
                    nxt = await asyncio.wait_for(self._queue.get(), remaining)
                except asyncio.TimeoutError:
                    break
            if nxt is None:
                self._closed = True
                break
            self._sort_item(items, nxt)
        return items

    def _sort_item(self, items: list, item) -> None:
        name = item[0].stream.name
        # defer when the stream is busy OR already has a deferred frame:
        # a newly dequeued frame must never overtake its stream's older
        # deferred frame into the current batch (per-stream ordering —
        # temporal clip buffers would silently reorder otherwise)
        if name in self._busy_streams or any(
            d[0].stream.name == name for d in self._deferred
        ):
            self._deferred.append(item)
        else:
            items.append(item)

    async def _process(self, items: Sequence[Tuple]) -> None:
        if self._temporal and self.clip_window_s > 0:
            await self._process_temporal(items)
            return
        packets = [it[0] for it in items]
        futures = [it[1] for it in items]
        submit_times = [it[2] for it in items]
        batch = spans.new_batch()
        t0 = time.perf_counter()
        try:
            results = await asyncio.to_thread(
                spans.run_batch, batch, self.engine.predict_packets, packets)
        except asyncio.CancelledError:
            # stop() abandoned this batch (wedged device call): resolve the
            # frames as shed so their submit() callers unblock
            for fut in futures:
                if not fut.done():
                    fut.set_result(None)
            raise
        except Exception as exc:  # noqa: BLE001
            logger.exception("batched inference failed: %s", exc)
            for fut in futures:
                if not fut.done():
                    fut.set_exception(RuntimeError(f"inference failed: {exc}"))
            return
        infer_ms = (time.perf_counter() - t0) * 1e3
        st = self.stats
        st.batches += 1
        st.frames += len(items)
        st.sum_batch_size += len(items)
        st.max_batch_size = max(st.max_batch_size, len(items))
        st.sum_infer_ms += infer_ms
        st.sum_wait_ms += sum((t0 - t) * 1e3 for t in submit_times)
        if self.metrics is not None:
            self.metrics.observe_batch(len(items), infer_ms / 1e3)
        if batch is not None:
            batch.carried(packets, submit_times)
        for fut, dets in zip(futures, results):
            if not fut.done():
                fut.set_result(dets)

    # -- temporal clip coalescing ----------------------------------------

    def _clip_flush_target(self) -> int:
        cfg = getattr(self.engine, "config", None)
        buckets = getattr(cfg, "resolved_buckets", None) if cfg else None
        return min(self.max_batch, buckets[-1]) if buckets else self.max_batch

    async def _process_temporal(self, items: Sequence[Tuple]) -> None:
        """Stage 1 of temporal inference: ring-buffer every frame (host,
        O(1)); frames that do not complete a clip resolve immediately with
        [] (the reference contract for in-buffer frames). Ready clips are
        parked up to ``clip_window_s`` so clips from other streams —
        arriving in later batcher ticks — join the same device batch."""
        st = self.stats
        st.frames += len(items)
        for packet, fut, t_sub in items:
            try:
                seq = self.engine.buffer_packet(packet)
            except Exception as exc:  # noqa: BLE001 - malformed frame etc.
                logger.exception("temporal frame buffering failed: %s", exc)
                if not fut.done():
                    fut.set_exception(RuntimeError(f"inference failed: {exc}"))
                continue
            if seq is None:
                if not fut.done():
                    fut.set_result([])
            else:
                self._pending_clips.append((seq, fut, t_sub))
        if not self._pending_clips:
            return
        if len(self._pending_clips) >= self._clip_flush_target():
            await self._flush_clips()
        elif self._clip_timer is None:
            self._clip_timer = asyncio.create_task(
                self._clip_timer_run(), name="clip-flush-timer"
            )

    async def _clip_timer_run(self) -> None:
        try:
            await asyncio.sleep(self.clip_window_s)
            self._clip_timer = None
            await self._flush_clips()
        except asyncio.CancelledError:  # flushed early or shutdown
            pass

    async def _flush_clips(self) -> None:
        if self._clip_timer is not None:
            self._clip_timer.cancel()
            self._clip_timer = None
        all_pending, self._pending_clips = self._pending_clips, []
        if not all_pending:
            return
        # chunk to the largest warmed compile bucket: a single oversized
        # predict_clips call (many streams completing clips at once, or
        # accumulation during an in-flight flush) would hit an unwarmed
        # batch shape and JIT-compile mid-serving — a multi-second stall
        chunk = max(1, self._clip_flush_target())
        for lo in range(0, len(all_pending), chunk):
            pending = all_pending[lo:lo + chunk]
            t0 = time.perf_counter()
            try:
                results = await asyncio.to_thread(
                    self.engine.predict_clips, [seq for seq, _, _ in pending]
                )
            except asyncio.CancelledError:
                # abandoned by stop(): resolve this chunk AND the not-yet-
                # flushed remainder as shed so their callers unblock
                for _, fut, _ in all_pending[lo:]:
                    if not fut.done():
                        fut.set_result(None)
                raise
            except Exception as exc:  # noqa: BLE001
                logger.exception("batched clip inference failed: %s", exc)
                for _, fut, _ in pending:
                    if not fut.done():
                        fut.set_exception(RuntimeError(f"inference failed: {exc}"))
                continue
            infer_ms = (time.perf_counter() - t0) * 1e3
            st = self.stats
            st.batches += 1
            st.clip_batches += 1
            st.clips += len(pending)
            st.sum_clip_batch_size += len(pending)
            st.sum_batch_size += len(pending)
            st.max_batch_size = max(st.max_batch_size, len(pending))
            st.sum_infer_ms += infer_ms
            st.sum_wait_ms += sum((t0 - t) * 1e3 for _, _, t in pending)
            if self.metrics is not None:
                self.metrics.observe_batch(len(pending), infer_ms / 1e3)
            for (_, fut, _), dets in zip(pending, results):
                if not fut.done():
                    fut.set_result(dets)
