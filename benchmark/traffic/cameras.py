"""Live cameras into one ``AnalyticsPipeline`` process.

The mix file gives ``cameras`` streams of ``width`` x ``height`` at ``fps``,
each a pooled ``synthetic://`` source of ``pool`` pre-rendered frames with
``boxes`` moving rectangles of ``min_size`` to ``max_size`` of each side,
seeded from the run's seed and the camera's index; the pipeline settings
``batch_size`` (in-flight frames a stream), ``batch_window_ms``, the
engine's ``buckets``, and the sink's ``include_frames``, ``frame_quality``
and ``frame_interval_seconds`` (a preview image an event, at most one a
stream every that many seconds); ``ramp_seconds`` of traffic before the
window and ``tail_seconds`` after it; and ``check_frames``, about how many
frames the check samples.
Adaptive frame rates, motion filters and ROI masks are off, so that every
seed offers the same frames; the sink is in memory, and each event leaves
it once sent, as a consumer would take it; Prometheus and snapshots are
off.

Set-up renders the pools, writes the checkpoint, and starts the pipeline
through ``AnalyticsPipeline.run_for`` (which builds and warms the engine,
capturing every bucket); the window opens ``ramp_seconds`` after the
pipeline has started and closes ``seconds`` later. The cameras run on for
``tail_seconds``, so that every frame read in the window reaches the sink
in steady serving, late or not, and not in the pipeline's shutdown, which
sheds what is still queued; then ``run_for``'s time ends, and the pipeline
drains and stops.

Taps, installed on the objects the pipeline hands out and none of its
files: each stream worker's ``_process_packet`` stamps a frame's read (host
clock), the sink's ``send_tracks`` stamps its event, and the batcher's
``submit_nowait`` keeps, for frames drawn from the seed, the frame and the
detections the batcher hands back. Readings: sink events and reads in the
window, the latency of every frame whose event fell in the window, the
batcher's counters over the window, frames attempted (read in the window)
and failed (read in the window and never at the sink once the pipeline has
stopped: shed, errored or dropped).
"""

from __future__ import annotations

import asyncio
import hashlib
import sys
import time

import numpy as np

STATS = ("batches", "frames", "sum_batch_size", "sum_infer_ms", "sum_wait_ms", "shed")


def pipeline_config(ctx, model_path: str):
    from realtime_analytics_tpu_torch.config import (
        KafkaSinkConfig,
        PipelineConfig,
        PrometheusConfig,
        SnapshotConfig,
        StreamConfig,
        TrackerConfig,
    )

    mix = ctx.mix
    streams = [
        StreamConfig(
            name=f"cam-{i:03d}",
            url=(f"synthetic://?width={mix['width']}&height={mix['height']}"
                 f"&boxes={mix['boxes']}&min_size={mix['min_size']}&max_size={mix['max_size']}"
                 f"&seed={ctx.seed * 1000 + i}&pool={mix['pool']}"),
            target_fps=mix["fps"], warmup_seconds=0.0, batch_size=mix["batch_size"],
            adaptive_fps=False)
        for i in range(mix["cameras"])
    ]
    return PipelineConfig(
        streams=streams,
        detector=ctx.detector_config(model_path, mix["buckets"], warmup=True),
        tracker=TrackerConfig(),
        kafka=KafkaSinkConfig(enabled=True, transport="memory",
                              include_frames=mix["include_frames"],
                              frame_quality=mix["frame_quality"],
                              frame_interval_seconds=mix["frame_interval_seconds"]),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        batch_window_ms=mix["batch_window_ms"],
        stats_interval_seconds=3600,
    )


def sampled(seed: int, name: str, frame_id: int, rate: float) -> bool:
    h = hashlib.blake2b(f"{seed}/{name}/{frame_id}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") < rate * 2.0 ** 64


class Taps:
    """The read and sink stamps and the sampled results of one pipeline."""

    def __init__(self, seed: int, rate: float):
        self.seed, self.rate = seed, rate
        self.reads = {}  # (stream, frame_id) -> host clock at the read
        self.sinks = {}  # (stream, frame_id) -> host clock at the sink event
        self.samples = []

    def install(self, pipeline) -> None:
        for w in pipeline.workers:
            w._process_packet = self._read_tap(w._process_packet)
        pipeline.kafka.send_tracks = self._sink_tap(pipeline.kafka)
        for b in pipeline.batchers.values():
            b.submit_nowait = self._submit_tap(b.submit_nowait)

    def _read_tap(self, inner):
        async def tapped(packet):
            self.reads[(packet.stream.name, packet.frame_id)] = time.perf_counter()
            return await inner(packet)
        return tapped

    def _sink_tap(self, sink):
        inner = sink.send_tracks

        async def tapped(stream_name, frame_id, *args, **kwargs):
            self.sinks[(stream_name, frame_id)] = time.perf_counter()
            await inner(stream_name, frame_id, *args, **kwargs)
            sink.memory_buffer.clear()
        return tapped

    def _submit_tap(self, inner):
        def tapped(packet):
            fut = inner(packet)
            if sampled(self.seed, packet.stream.name, packet.frame_id, self.rate):
                fut.add_done_callback(lambda f, p=packet: self._keep(p, f))
            return fut
        return tapped

    def _keep(self, packet, fut) -> None:
        if fut.cancelled() or fut.exception() is not None or fut.result() is None:
            return
        dets = fut.result()
        boxes = np.array([d.bbox_xyxy for d in dets], np.float32).reshape(-1, 4)
        scores = np.array([d.confidence for d in dets], np.float32)
        classes = np.array([d.class_id for d in dets], np.int64)
        self.samples.append((id(packet.frame), packet.frame, boxes, scores, classes))


def stats(batcher) -> dict:
    return {k: getattr(batcher.stats, k) for k in STATS}


def run(ctx) -> dict:
    from realtime_analytics_tpu_torch.ingest.synthetic import prerender_pool
    from realtime_analytics_tpu_torch.pipeline import AnalyticsPipeline

    mix = ctx.mix
    cfg = pipeline_config(ctx, ctx.checkpoint())
    for s in cfg.streams:
        prerender_pool(s.url)
    ctx.tracer.warm(ctx.device)
    offered = mix["cameras"] * mix["fps"]
    taps = Taps(ctx.seed, min(1.0, mix["check_frames"] / (offered * ctx.seconds)))
    pipeline = AnalyticsPipeline(cfg)
    started = asyncio.Event()
    start = pipeline.start

    async def tapped_start():
        await start()
        taps.install(pipeline)
        started.set()

    pipeline.start = tapped_start
    window = {}

    async def drive():
        runner = asyncio.create_task(pipeline.run_for(
            mix["ramp_seconds"] + ctx.seconds + mix["tail_seconds"]))
        waiter = asyncio.create_task(started.wait())
        await asyncio.wait({runner, waiter}, return_when=asyncio.FIRST_COMPLETED)
        if not started.is_set():
            waiter.cancel()
            await runner  # start failed: raise its error
            raise RuntimeError("the pipeline stopped before it started")
        await asyncio.sleep(mix["ramp_seconds"])
        batcher = next(iter(pipeline.batchers.values()))
        t_open = ctx.open_window()
        window["open"] = stats(batcher)
        await asyncio.sleep(max(0.0, ctx.t_close - ctx.tracer_seconds - time.perf_counter()))
        ctx.tracer.start()
        await asyncio.sleep(max(0.0, ctx.t_close - time.perf_counter()))
        window["close"] = stats(batcher)
        ctx.tracer.mark_end()
        await runner
        return t_open

    t_open = asyncio.run(drive())
    ctx.tracer.stop()  # once the pipeline has stopped: no step runs across it
    t_close = t_open + ctx.seconds
    in_window = [k for k, t in taps.reads.items() if t_open <= t < t_close]
    latencies = np.array([(t - taps.reads[k]) * 1e3 for k, t in taps.sinks.items()
                          if t_open <= t < t_close and k in taps.reads])
    sink_events = sum(1 for t in taps.sinks.values() if t_open <= t < t_close)
    delta = {k: window["close"][k] - window["open"][k] for k in STATS}
    lost = sorted(taps.reads[k] - t_close for k in in_window if k not in taps.sinks)
    if lost:
        print(f"cameras: {len(lost)} frames read in the window never reached the sink, "
              f"read {lost[0]:.3f} to {lost[-1]:.3f} s from its close", file=sys.stderr)
    return {
        "window_s": ctx.seconds, "sink_events": sink_events, "reads": len(in_window),
        "offered_fps": offered, "latencies_ms": latencies, "batcher": delta,
        "max_batch": max(mix["buckets"]),
        "attempted": len(in_window),
        "failed": len(lost),
        "samples": taps.samples,
    }
