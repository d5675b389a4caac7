"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over the last
``SECONDS`` of the measured window, reduced to what the per-layer readers
and the result line take.

* ``busy_s``: the time in which a kernel or a copy ran on the device, the
  overlaps merged (a ``record_function`` range the program marks on the
  device timeline, such as ``captured_step``, is no work and is left out); ``window_s``: the traced span on the host clock, from
  the profiler's start to its stop, or to the end ``Tracer.mark_end``
  marks, where what follows the mark is left out (its device tracing is
  loaded once in set-up, ``Tracer.warm``, so that the start in the window
  is quick);
* ``kernels``: device time and launches by kernel name (a replayed CUDA
  graph's kernels come one by one);
* ``breakdown``: the 10 device operations that took most time, and the idle
  gaps of the device summed by what the host was doing in them: the
  innermost host event (an ``aten`` op or a CUDA runtime call) at the gap's
  middle, or ``host: no recorded op`` (Python between calls).
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

SECONDS = 3.0
TOP = 10
NAME_CHARS = 120
MARK = "benchmark.traced_window_end"


def merged(intervals) -> List[Tuple[float, float]]:
    """Sorted, overlap-free union of (start, end) intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(device_events, host_events) -> Dict:
    """``device_events`` and ``host_events``: (name, start_us, end_us)."""
    if not device_events:
        return {}
    spans = merged((s, e) for _, s, e in device_events)
    busy = sum(e - s for s, e in spans)
    start = min(s for _, s, _ in list(device_events) + list(host_events))
    end = max(e for _, _, e in list(device_events) + list(host_events))
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, s, e in device_events:
        k = kernels[name]
        k[0] += (e - s) / 1e6
        k[1] += 1
    hosts = sorted(host_events, key=lambda h: h[1])
    gaps: Dict[str, float] = defaultdict(float)
    active: List[Tuple[str, float, float]] = []
    i = 0
    for (_, e0), (s1, _) in zip(spans, spans[1:]):  # gaps in time order
        mid = (e0 + s1) / 2
        while i < len(hosts) and hosts[i][1] <= mid:
            active.append(hosts[i])
            i += 1
        active = [h for h in active if h[2] >= mid]
        label = (min(active, key=lambda h: h[2] - h[1])[0] if active
                 else "host: no recorded op")
        gaps[label[:NAME_CHARS]] += (s1 - e0) / 1e6
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:TOP]
    return {
        "busy_s": busy / 1e6,
        "window_s": (end - start) / 1e6,
        "kernels": {k: tuple(v) for k, v in kernels.items()},
        "breakdown": {
            "device_ops": [[n[:NAME_CHARS], v[0]] for n, v in top_ops],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }


def rows(events):
    """(device, host) rows (name, start_us, end_us) of the profiler's
    events, cut at the ``MARK`` event where there is one: what starts after
    it is left out, and what runs across it ends there."""
    from torch.autograd import DeviceType

    cut = min((e.time_range.start for e in events if e.name == MARK), default=None)
    dev, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.name == MARK or (cut is not None and start >= cut):
            continue
        row = (e.name, start, end if cut is None else min(end, cut))
        if e.device_type != DeviceType.CUDA:
            host.append(row)
        elif not getattr(e, "is_user_annotation", False):  # a range, not work
            dev.append(row)
    return dev, host


class Tracer:
    """Starts the profiler ``SECONDS`` before the window closes and stops it
    once the window has closed; a driver whose program still runs on other
    threads at the close marks the end there (``mark_end``) and stops the
    profiler once they are done. Inert when ``enabled`` is false."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self._t_end = None
        self.summary: Optional[Dict] = None

    def start(self) -> None:
        if not self.enabled or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def mark_end(self) -> None:
        """The traced window ends now; ``stop`` leaves out what follows."""
        if self._prof is None:
            return
        from torch.profiler import record_function

        self._t_end = time.perf_counter()
        with record_function(MARK):
            pass

    def stop(self) -> None:
        if self._prof is None:
            return
        window = (self._t_end or time.perf_counter()) - self._t0
        self._prof.stop()
        self.summary = summarize(*rows(self._prof.events()))
        if self.summary:
            self.summary["window_s"] = window
        self._prof = None

    def warm(self, device) -> None:
        """Load the profiler's device tracing once in set-up: its first
        start takes seconds, which must not fall in the window."""
        if not self.enabled:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            torch.ones(1, device=device).add_(1)
            if torch.cuda.is_available():
                torch.cuda.synchronize()
