"""Readings that several metrics share; each metric's own file under
``metrics/`` names which it reports (a metric of one quantity in two cells
has a file a cell). Each function returns None where its run has nothing
to read."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .counts import nms_work, peak, roofline_time, stem_widths, stem_work


def _get(run, key):
    return run.readings.get(key)


def sink_fps(run) -> Optional[float]:
    n = _get(run, "sink_events")
    return None if n is None else n / run.window_s


def footage_fps(run) -> Optional[float]:
    n = _get(run, "frames")
    return None if n is None else n / run.window_s


def latency_ms(run, q: float) -> Optional[float]:
    lat = _get(run, "latencies_ms")
    if lat is None or len(lat) == 0:
        return None
    return float(np.percentile(lat, q))


def read_share(run) -> Optional[float]:
    reads = _get(run, "reads")
    if reads is None:
        return None
    return 100.0 * reads / (run.readings["offered_fps"] * run.window_s)


def batcher(run, num: str, den: str, scale: float = 1.0) -> Optional[float]:
    d = _get(run, "batcher")
    if not d or not d[den]:
        return None
    return scale * d[num] / d[den]


def mfu(run, frames: Optional[float]) -> Optional[float]:
    """The whole step's share of the card's dense peak in the configuration's
    precision: the plain forward's FLOPs a frame (frozen in the
    configuration) times the frames served, over the window."""
    p = peak(run.kind, run.config["precision"])
    if frames is None or p is None:
        return None
    return 100.0 * run.config["flops_per_image"] * frames / run.window_s / p


def idle_share(run) -> Optional[float]:
    t = run.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def _kernel_time(run, *names):
    """(seconds, launches) of the trace's kernels whose name holds one of ``names``."""
    secs = launches = 0
    for name, (s, n) in run.trace.get("kernels", {}).items():
        if any(k in name for k in names):
            secs, launches = secs + s, launches + n
    return secs, launches


def stem_roofline(run) -> Optional[float]:
    """B3's share of its roofline at the cell's batch and stem widths."""
    n = _get(run, "batch")
    mma_s, mma_n = _kernel_time(run, "stem_mma_kernel")
    gen_s, gen_n = _kernel_time(run, "stem_general_kernel")
    if n is None or not (mma_n or gen_n):
        return None
    size = run.config["input_size"]
    c0, c1 = stem_widths(run.config["scale"])
    esz = 2 if run.config["precision"] == "bf16" else 4
    flops, nbytes = stem_work(n, size, size, c0, c1, esz)
    dtype = "bf16" if mma_n else "fp32"  # the mma kernel runs on the tensor cores
    least = roofline_time(flops, nbytes, run.kind, dtype)
    if least is None:
        return None
    return 100.0 * least / ((mma_s + gen_s) / (mma_n + gen_n))


def nms_roofline(run) -> Optional[float]:
    """B6's share of its roofline: both passes of a step, at the cell's
    batch and ``pre_nms_topk``."""
    n = _get(run, "batch")
    mask_s, _ = _kernel_time(run, "nms_mask_kernel")
    chain_s, steps = _kernel_time(run, "nms_chain_kernel")
    if n is None or not steps:
        return None
    ops, nbytes = nms_work(n, run.config["pre_nms_topk"])
    least = roofline_time(ops, nbytes, run.kind, "fp32")
    if least is None:
        return None
    return 100.0 * least / ((mask_s + chain_s) / steps)
