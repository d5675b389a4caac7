"""Profiling hooks: torch.profiler traces + lightweight stage timers.

Counterpart of ``realtime_analytics_tpu/utils/profiling.py``: a
``torch.profiler`` trace around a region (the CPU, and the card's kernels
when one is visible) exported as a Chrome trace, plus the per-stage wall
timings already collected by StreamHealth / BatcherStats.

Usage:
    realtime-analytics-torch --config c.yaml --torch-profile /tmp/trace
    # then open /tmp/trace/trace-<pid>.json in chrome://tracing or Perfetto
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def torch_trace(logdir: Optional[str]) -> Iterator[None]:
    """Wrap a region in a torch.profiler trace when a logdir is given; the
    Chrome trace lands in ``logdir/trace-<pid>.json``, also when the region
    raises."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace-{os.getpid()}.json")
    logger.info("torch.profiler trace -> %s", path)
    prof = profile(activities=activities)
    try:
        with prof:
            yield
    finally:
        prof.export_chrome_trace(path)


class StageTimer:
    """Accumulating wall-clock timer for named pipeline stages."""

    def __init__(self) -> None:
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sums[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def snapshot(self) -> Dict[str, dict]:
        return {
            name: {
                "calls": self._counts[name],
                "total_s": round(self._sums[name], 4),
                "avg_ms": round(self._sums[name] / self._counts[name] * 1e3, 3),
            }
            for name in self._sums
        }

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()
