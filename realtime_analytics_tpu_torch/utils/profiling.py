"""Profiling hook: a torch.profiler trace of a region.

Counterpart of ``realtime_analytics_tpu/utils/profiling.py``: a
``torch.profiler`` trace around a region (the CPU, and the card's kernels
when one is visible) exported as a Chrome trace. While it records, the
serving path's spans (``telemetry/spans.py``) are on: their
``record_function`` ranges are in the trace.

Usage:
    realtime-analytics-torch --config c.yaml --torch-profile /tmp/trace
    # then open /tmp/trace/trace-<pid>.json in chrome://tracing or Perfetto
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

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
