"""Spans of the serving path: named host intervals, on while a
``torch.profiler`` session records in the process.

A span records its name, its start and end on ``time.perf_counter_ns()``'s
clock, the thread that ran it, the frame it belongs to (``(stream,
frame_id)``) and the sequence number of the batch that carried that frame.
With no profiler recording a span costs one check: nothing is kept and no
profiler range runs. That covers both uses of the port's profiler,
``realtime-analytics-torch --torch-profile DIR`` and a benchmark's traced
run, with no switch of its own.

While a profiler records:

* every span goes to ``LOG``, a bounded log that drops its oldest entries
  and holds the newest session only: the first span that finds a session
  recording empties it and notes the session's start on the same clock
  (a span that finds none ends the session in the log);
* a span of host work (``span``) is also a profiler range, so it lies on
  the profiler's clock beside the device's kernels. The profiler records
  host ranges only on the thread that started it, which in a pipeline is
  the event loop's: the engine's executor threads keep theirs in the log
  alone;
* a frame's waits, which cross an ``await`` or a thread, are kept in the
  log only, from stamps the code takes anyway.

A served frame's stages tile its life, each boundary shared by the two
stages it joins:

========== ==============================================================
slot_wait  the worker takes the packet from ``VideoStream.frames()`` ->
           the batcher's submit (the stream's in-flight slot)
queue_wait submit -> the engine thread starts the frame's batch (collect
           window, pipeline-depth wait, executor hop)
batch      the batch's engine work on the engine thread: ``pick``,
           ``lock``, ``step`` (``captured_step`` within), ``detections``
loop_wait  the engine thread returns the batch -> the frame's completer
           starts
complete   the completer: filter, ``tracker``, counters, ``sink``
========== ==============================================================

Shed frames have no batch, so no engine or complete spans.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import itertools
import threading
import time
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

CAPACITY = 1 << 17  # spans a session keeps: ~30 s of 32 cameras

Frame = Tuple[str, int]  # (stream, frame_id)

_OFF = contextlib.nullcontext()
_SEQ = itertools.count()
_FRAME: contextvars.ContextVar[Optional[Frame]] = contextvars.ContextVar(
    "span_frame", default=None)
_BATCH: contextvars.ContextVar[Optional["Batch"]] = contextvars.ContextVar(
    "span_batch", default=None)


# a profiler range: torch's C++ one, a few times cheaper than record_function
_range = torch._C._profiler._RecordFunctionFast


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int
    frame: Optional[Frame]
    batch: Optional[int]


class SpanLog:
    """The spans of the newest profiling session, the oldest dropped past
    ``capacity``, and the frames handed from a batch to their completers."""

    def __init__(self, capacity: int = CAPACITY) -> None:
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        self._carried: dict = {}  # frame -> (batch, submit_ns)
        self._capacity = capacity
        self._lock = threading.Lock()
        self._recording = False
        self.session_start_ns: Optional[int] = None

    def on(self) -> bool:
        """Whether spans are on now; the first check of a session empties
        the log and notes the session's start."""
        # torch's flag for a session in the process (``_profiler_enabled()``
        # answers for the calling thread only)
        if not _profiler._is_profiler_enabled:
            self._recording = False
            return False
        if not self._recording:
            with self._lock:
                if not self._recording:
                    self._spans.clear()
                    self._carried.clear()
                    self.session_start_ns = time.perf_counter_ns()
                    self._recording = True
        return True

    def add(self, span: Span) -> None:
        self._spans.append(span)

    def spans(self, name: Optional[str] = None) -> List[Span]:
        """The session's spans (of ``name`` where given), oldest first."""
        return [s for s in list(self._spans) if name is None or s.name == name]

    def hand_over(self, frame: Frame, batch: "Batch", submit_ns: int) -> None:
        if len(self._carried) >= self._capacity:  # frames no completer took
            self._carried.pop(next(iter(self._carried)))
        self._carried[frame] = (batch, submit_ns)

    def take(self, frame: Frame):
        """The batch that carried ``frame`` and its submit stamp, or None."""
        return self._carried.pop(frame, None)


LOG = SpanLog()


def _ns(t: float) -> int:
    """A ``time.perf_counter()`` stamp on ``perf_counter_ns``'s scale."""
    return round(t * 1e9)


class _Live:
    """A span of host work on this thread: a ``record_function`` range,
    kept in the log at its end. A scope (a batch, a frame's completion)
    makes its frame and batch those of the spans within it."""

    __slots__ = ("name", "frame", "batch", "start", "end", "_scope", "_tokens", "_range")

    def __init__(self, name: str, frame: Optional[Frame], batch: Optional["Batch"],
                 start: Optional[int] = None, scope: bool = False) -> None:
        self.name, self.frame, self.batch = name, frame, batch
        self.start, self.end, self._scope = start, None, scope

    def __enter__(self) -> "_Live":
        if self._scope:
            self._tokens = (_FRAME.set(self.frame), _BATCH.set(self.batch))
        self._range = _range(self.name)
        self._range.__enter__()
        if self.start is None:
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        if self._scope:
            _FRAME.reset(self._tokens[0])
            _BATCH.reset(self._tokens[1])
        LOG.add(Span(self.name, self.start, self.end, threading.get_ident(), self.frame,
                     None if self.batch is None else self.batch.seq))
        return False


def span(name: str):
    """``with span(name):`` around host work on this thread; it belongs to
    the frame and the batch the enclosing scope names."""
    if not LOG.on():
        return _OFF
    return _Live(name, _FRAME.get(), _BATCH.get())


def _wait(name: str, start_ns: int, end_ns: int, frame: Frame, batch: int) -> None:
    """A wait between two stamps: kept in the log only."""
    LOG.add(Span(name, start_ns, end_ns, threading.get_ident(), frame, batch))


class Batch:
    """One batch of the engine: its sequence number and, once it has run
    (``run_batch``), the start and end of its engine work."""

    __slots__ = ("seq", "start_ns", "end_ns")

    def __init__(self) -> None:
        self.seq = next(_SEQ)
        self.start_ns = self.end_ns = None

    def carried(self, packets: Iterable, submit_s: Iterable[float]) -> None:
        """The frames the batch served, with their submit stamps (host
        clock): each frame's completer takes them up."""
        for packet, t in zip(packets, submit_s):
            LOG.hand_over((packet.stream.name, packet.frame_id), self, _ns(t))


def new_batch() -> Optional[Batch]:
    """A batcher's next batch; None where spans are off."""
    return Batch() if LOG.on() else None


def run_batch(batch: Optional[Batch], fn: Callable, *args):
    """``fn(*args)``, where there is a batch as its engine work on this
    thread: a ``batch`` span, the scope of the spans within."""
    if batch is None:
        return fn(*args)
    live = _Live("batch", None, batch, scope=True)
    try:
        with live:
            return fn(*args)
    finally:
        batch.start_ns, batch.end_ns = live.start, live.end


def engine_batch():
    """``with engine_batch():`` around an engine entry point
    (``predict_arrays``, ``predict_packets``): a batch of its own where
    spans are on and no caller's batch (the batcher's ``run_batch``) is
    running."""
    if _BATCH.get() is not None or not LOG.on():
        return _OFF
    return _Live("batch", None, Batch(), scope=True)


def completing(stream: str, frame_id: int, read_s: float):
    """``with completing(...):`` around a served frame's completion: its
    ``complete`` span, the scope of ``tracker`` and ``sink``. Its earlier
    stages close up here, from the read stamp (``read_s``, host clock), the
    batcher's submit stamp and its batch's engine span."""
    if not LOG.on():
        return _OFF
    frame = (stream, frame_id)
    now = time.perf_counter_ns()
    carried = LOG.take(frame)
    batch = None
    if carried is not None and carried[0].end_ns is not None:
        batch, submit = carried
        _wait("slot_wait", _ns(read_s), submit, frame, batch.seq)
        _wait("queue_wait", submit, batch.start_ns, frame, batch.seq)
        _wait("loop_wait", batch.end_ns, now, frame, batch.seq)
    return _Live("complete", frame, batch, start=now, scope=True)
