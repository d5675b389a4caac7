"""The serving path's spans (``telemetry/spans.py``) on the CPU.

With no profiler recording, nothing is kept and no ``record_function`` runs.
Under a CPU ``torch.profiler`` the spans are kept with their frame and batch
ids, and those on the profiler's thread are ``record_function`` ranges on
the log's clock. A new session empties the log, which stays within its
bound. A short ``AnalyticsPipeline.run_for`` under a profiler: each served
frame's stages tile its life from its read to its sink, its batch has its
own pick and step spans, and shed frames have none. ``predict_arrays`` logs
one batch, pick and step a call, ``predict_packets`` called directly a
batch of its own, and a captured step its lock, step and ``captured_step``.
"""

import asyncio
import statistics
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from realtime_analytics_tpu_torch.config import (
    DetectorConfig,
    KafkaSinkConfig,
    PipelineConfig,
    PrometheusConfig,
    SnapshotConfig,
    StreamConfig,
    TrackerConfig,
)
from realtime_analytics_tpu_torch.engine import graphs
from realtime_analytics_tpu_torch.engine.batcher import InferenceBatcher
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine
from realtime_analytics_tpu_torch.pipeline import AnalyticsPipeline
from realtime_analytics_tpu_torch.telemetry import spans
from realtime_analytics_tpu_torch.types import FramePacket

INPUT = 64
SRC = (192, 192)  # an exact 3x host pick to the input


def _config(**over):
    kw = dict(model_path="__random__.pt", model_type="yolov8", device="cpu",
              confidence_threshold=0.01, warmup=False, input_size=[INPUT, INPUT],
              max_batch_size=4, batch_buckets=[2, 4], precision="fp32", pre_nms_topk=64)
    kw.update(over)
    return DetectorConfig(**kw)


@pytest.fixture(scope="module")
def engine():
    eng = TorchYoloEngine(_config())
    eng.warmup(SRC)
    return eng


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *SRC, 3), dtype=np.uint8)


def _session():
    """A CPU profiler session, started after a span check that found none
    recording (as the serving path makes at every frame): a new session."""
    assert not spans.LOG.on()
    return profile(activities=[ProfilerActivity.CPU])


class _Graph:
    """What ``CapturedStep`` asks of its CUDA graph, on the CPU: a replay
    recomputes the captured outputs in place."""

    def __init__(self, pool):
        pass

    def warm(self, fn, x):
        fn(x)

    def capture(self, fn, x):
        self.fn, self.x = fn, x
        self.outputs = tuple(fn(x))
        return self.outputs

    def replay(self):
        for out, res in zip(self.outputs, self.fn(self.x)):
            out.copy_(res)


def _captured_step():
    cache = graphs.StepCache()
    cache._pool = ("stand-in",)
    return graphs.CapturedStep(lambda x: (x.to(torch.float32) * 2,), (2, 4, 4, 3),
                               torch.uint8, torch.device("cpu"), key=(2, 4, 4),
                               cache=cache, graph_type=_Graph)


def _serve_batch(engine, n=2, stream="cam"):
    async def go():
        batcher = InferenceBatcher(engine, max_batch=4, batch_window_ms=1.0)
        await batcher.start()
        cfg = StreamConfig(name=stream, url="synthetic://", batch_size=n)
        futs = [batcher.submit_nowait(FramePacket(cfg, f, i, 0.0))
                for i, f in enumerate(_frames(n))]
        out = await asyncio.gather(*futs)
        await batcher.stop()
        return out
    return asyncio.run(go())


def test_no_profiler_keeps_nothing_and_records_no_range(engine, monkeypatch):
    ranges = []
    monkeypatch.setattr(spans, "_range", lambda name: ranges.append(name))
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name, *a, **k: ranges.append(name))
    before = spans.LOG.spans()
    assert not spans.LOG.on()
    engine.predict_arrays(_frames(2))
    assert all(d is not None for d in _serve_batch(engine))
    _captured_step().run_host(np.ones((2, 4, 4, 3), np.uint8))
    with spans.completing("cam", 0, time.perf_counter()):
        with spans.span("tracker"):
            pass
    assert ranges == []
    assert spans.LOG.spans() == before


def _pick():
    with spans.span("pick"):
        time.sleep(0.001)


def test_spans_carry_their_frame_and_batch_and_lie_on_the_profilers_clock():
    with ThreadPoolExecutor(1) as pool, _session() as prof:
        batch = spans.new_batch()
        # the engine's work on another thread: kept in the log
        pool.submit(spans.run_batch, batch, _pick).result()
        batch.carried([FramePacket(StreamConfig(name="cam", url="x"), None, 7, 0.0)],
                      [time.perf_counter() - 0.01])
        with spans.completing("cam", 7, time.perf_counter() - 0.02):
            with spans.span("tracker"):
                time.sleep(0.002)
        with spans.engine_batch():
            _pick()
    log = spans.LOG.spans()
    by_name = defaultdict(list)
    for s in log:
        by_name[s.name].append(s)
    engine_thread = [s for s in log if s.thread != threading.get_ident()]
    assert {s.name for s in engine_thread} == {"batch", "pick"}
    assert all(s.batch == batch.seq for s in engine_thread)
    (tracker,) = by_name["tracker"]
    (complete,) = by_name["complete"]
    assert tracker.frame == complete.frame == ("cam", 7)
    assert tracker.batch == complete.batch == batch.seq
    assert complete.start_ns <= tracker.start_ns <= tracker.end_ns <= complete.end_ns
    for name in ("slot_wait", "queue_wait", "loop_wait"):
        (w,) = by_name[name]
        assert (w.frame, w.batch) == (("cam", 7), batch.seq)
    own = [s for s in by_name["batch"] if s.batch != batch.seq]
    assert len(own) == 1 and by_name["pick"][-1].batch == own[0].batch
    # the waits close up from stamps taken before; every live span starts in the session
    live = [s for s in log if not s.name.endswith("_wait")]
    assert spans.LOG.session_start_ns <= min(s.start_ns for s in live)

    # the ranges of the profiler's own thread: the log's times after one offset
    events = {e.name: e for e in prof.events()}
    here = [s for s in log if s.thread == threading.get_ident()
            and s.name in ("complete", "tracker", "batch", "pick")]
    assert {s.name for s in here} == {"complete", "tracker", "batch", "pick"}
    diffs = [(s.start_ns / 1e3 - events[s.name].time_range.start,
              s.end_ns / 1e3 - events[s.name].time_range.end) for s in here]
    offset = statistics.median(d for pair in diffs for d in pair)
    assert all(abs(d - offset) < 1000.0 for pair in diffs for d in pair), diffs


def test_a_new_session_empties_the_log_and_the_log_stays_bounded(monkeypatch):
    with _session():
        with spans.span("first"):
            pass
    with _session():
        start = spans.LOG.on() and spans.LOG.session_start_ns
        with spans.span("second"):
            pass
    assert [s.name for s in spans.LOG.spans()] == ["second"]
    assert start <= spans.LOG.spans()[0].start_ns

    small = spans.SpanLog(capacity=8)
    monkeypatch.setattr(spans, "LOG", small)
    with _session():
        for i in range(20):
            with spans.span(f"s{i}"):
                pass
    assert [s.name for s in small.spans()] == [f"s{i}" for i in range(12, 20)]


def test_predict_arrays_logs_a_batch_a_pick_and_a_step_a_call(engine):
    with _session():
        for seed in range(3):
            engine.predict_arrays(_frames(2, seed))
    log = spans.LOG.spans()
    batches = [s.batch for s in log if s.name == "batch"]
    assert len(set(batches)) == 3
    for name in ("pick", "step"):
        assert sorted(s.batch for s in log if s.name == name) == sorted(batches)


def test_predict_packets_called_directly_logs_a_batch_of_its_own(engine):
    cfg = StreamConfig(name="cam", url="synthetic://")
    packets = [FramePacket(cfg, f, i, 0.0) for i, f in enumerate(_frames(2))]
    with _session():
        engine.predict(packets[0])
        batch = spans.new_batch()
        spans.run_batch(batch, engine.predict_packets, packets)  # the batcher's
    log = spans.LOG.spans()
    batches = [s.batch for s in log if s.name == "batch"]
    assert len(batches) == 2 and batch.seq in batches
    assert None not in batches
    for name in ("pick", "step", "detections"):
        assert sorted(s.batch for s in log if s.name == name) == sorted(batches)


def test_a_captured_step_logs_its_lock_step_and_replay():
    step = _captured_step()
    with _session() as prof:
        step.run_host(np.ones((2, 4, 4, 3), np.uint8))
    names = [s.name for s in spans.LOG.spans()]
    assert sorted(names) == ["captured_step", "lock", "step"]
    assert {"captured_step", "lock", "step"} <= {e.name for e in prof.events()}


def test_pipeline_frames_tile_read_to_sink_and_shed_frames_have_no_spans():
    cfg = PipelineConfig(
        streams=[StreamConfig(name=f"cam-{i}", url=f"synthetic://?width=192&height=192&seed={i}",
                              warmup_seconds=0.0, target_fps=25, batch_size=2)
                 for i in range(3)],
        detector=_config(warmup=True, confidence_threshold=0.005),
        tracker=TrackerConfig(min_hits=1),
        kafka=KafkaSinkConfig(enabled=True, transport="memory"),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        stats_interval_seconds=30,
    )
    pipeline = AnalyticsPipeline(cfg)
    reads, sinks, shed = {}, {}, set()
    start = pipeline.start

    async def tapped_start():
        await start()
        batcher = pipeline.batchers["__default__"]
        # a batch outlasts a frame's interval and cam-0 may keep one frame in
        # flight: its next frame, read while the last is in flight, is shed
        batcher._inflight_cap = {"cam-0": 1}
        predict = batcher.engine.predict_packets
        batcher.engine.predict_packets = lambda p: (time.sleep(0.05), predict(p))[1]
        for w in pipeline.workers:
            inner = w._process_packet

            async def read(packet, inner=inner):
                reads[(packet.stream.name, packet.frame_id)] = time.perf_counter_ns()
                await inner(packet)
            w._process_packet = read
        send = pipeline.kafka.send_tracks

        async def sink(name, frame_id, *a, **k):
            sinks[(name, frame_id)] = time.perf_counter_ns()
            await send(name, frame_id, *a, **k)
        pipeline.kafka.send_tracks = sink
        submit = batcher.submit_nowait

        def tapped(packet):
            fut = submit(packet)
            key = (packet.stream.name, packet.frame_id)
            fut.add_done_callback(lambda f: f.result() is None and shed.add(key))
            return fut
        batcher.submit_nowait = tapped

    pipeline.start = tapped_start
    with _session() as prof:
        asyncio.run(pipeline.run_for(2.5))
    log = spans.LOG.spans()
    # the loop's ranges are on the profiler's clock (here the loop's thread started it)
    assert {"complete", "tracker", "sink"} <= {e.name for e in prof.events()}
    frames = defaultdict(dict)
    batches = defaultdict(dict)
    for s in log:
        if s.frame is not None and s.name in ("slot_wait", "queue_wait", "loop_wait",
                                              "complete"):
            frames[s.frame][s.name] = s
        elif s.frame is None and s.batch is not None:
            batches[s.batch][s.name] = s
    served = [k for k, st in frames.items() if "complete" in st]
    assert len(served) >= 20 and set(served) <= set(sinks)
    for key in served:
        st = frames[key]
        slot, queue, loop, done = (st[n] for n in ("slot_wait", "queue_wait", "loop_wait",
                                                   "complete"))
        assert slot.batch == queue.batch == loop.batch == done.batch
        eng = batches[done.batch]
        assert {"batch", "pick", "step", "detections"} <= set(eng)
        assert slot.end_ns == queue.start_ns and queue.end_ns == eng["batch"].start_ns
        assert eng["batch"].end_ns == loop.start_ns and loop.end_ns == done.start_ns
        for s in (slot, queue, eng["batch"], loop, done):
            assert s.start_ns <= s.end_ns
        # the stages run from the read to past the sink
        assert 0 <= slot.start_ns - reads[key] < 5e6
        assert done.start_ns <= sinks[key] <= done.end_ns
    assert shed and not shed & set(served)
    assert not [s for s in log if s.frame in shed]
    for s in log:
        if s.name in ("tracker", "sink"):
            assert frames[s.frame]["complete"].start_ns <= s.start_ns
            assert s.end_ns <= frames[s.frame]["complete"].end_ns
