"""The clip cells' arithmetic: B7's work in a SlowFast step and the readers
that divide it, or the step's FLOPs, by a time. Peaks are ``counts.py``'s.

A SlowFast R50 step at batch N runs B7 once after every conv (110 calls):
the two stems and four laterals with ReLU, in each bottleneck ``a`` and
``b`` with ReLU and ``c`` adding its shortcut before the ReLU, and each
stage's first projection without an activation. A call reads the conv's
output and writes it in place, reads the shortcut where there is one, and
reads its bias: ``epilogue_work`` counts those bytes once each, and one
operation for the bias, one for the ReLU and one for the shortcut's add per
element. The shapes follow PySlowFast's network at the configuration's
sizes (``reference/slowfast.py``): the stems at stride 2 then the pool at
2, res3-res5 at stride 2 in their first block, the slow pathway on
``num_frames / alpha`` frames, the fast one on all of them, the laterals at
the slow pathway's frames.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .counts import peak, roofline_time

EPILOGUE_KERNEL = "conv_epilogue_kernel"


def epilogue_calls(config: Dict) -> List[Tuple[int, int, bool]]:
    """(elements of one clip's output, channels, adds a shortcut) of each
    B7 call of a SlowFast forward, in no particular order."""
    alpha, beta = config["alpha"], config["beta_inv"]
    width, ratio = config["width_per_group"], config["fusion_conv_channel_ratio"]
    t_len, s = config["num_frames"], config["crop_size"] // 2
    frames = (t_len // alpha, t_len)  # slow, fast
    calls = [(frames[0] * s * s * width, width, False),
             (frames[1] * s * s * (width // beta), width // beta, False)]
    s //= 2  # the stems' max pool
    fast_in = width // beta
    for stage, depth in enumerate(config["depths"]):
        calls.append((frames[0] * s * s * fast_in * ratio, fast_in * ratio, False))  # lateral
        stride = 1 if stage == 0 else 2
        out_s = s // stride
        inner = width * 2 ** stage
        for t, div in zip(frames, (1, beta)):
            ci, co = inner // div, 4 * inner // div
            for i in range(depth):
                s_in = s if i == 0 else out_s
                calls += [(t * s_in * s_in * ci, ci, False),  # a
                          (t * out_s * out_s * ci, ci, False),  # b
                          (t * out_s * out_s * co, co, True)]  # c, with the shortcut
                if i == 0:
                    calls.append((t * out_s * out_s * co, co, False))  # projection
        s, fast_in = out_s, 4 * inner // beta
    return calls


def epilogue_work(config: Dict, batch: int, esz: int) -> Tuple[float, float]:
    """(operations, bytes) of B7's calls in one step of ``batch`` clips, in
    elements of ``esz`` bytes."""
    ops = nbytes = 0.0
    for elems, channels, shortcut in epilogue_calls(config):
        n = batch * elems
        ops += n * (3 if shortcut else 2)
        nbytes += (n * (3 if shortcut else 2) + channels) * esz
    return ops, nbytes


def _kernel(run, name: str) -> Tuple[float, int]:
    """(seconds, launches) of the trace's kernels whose name holds ``name``."""
    secs, launches = 0.0, 0
    for kernel, (s, n) in run.trace.get("kernels", {}).items():
        if name in kernel:
            secs, launches = secs + s, launches + n
    return secs, launches


def epilogue_roofline(run) -> Optional[float]:
    """B7's share of its roofline: its least time a step (bytes over HBM's
    peak) over its mean device time a step in the trace (launches / 110
    steps)."""
    n = run.readings.get("batch")
    secs, launches = _kernel(run, EPILOGUE_KERNEL)
    per_step = len(epilogue_calls(run.config))
    if not n or launches < per_step:
        return None
    esz = 2 if run.config["precision"] == "bf16" else 4
    ops, nbytes = epilogue_work(run.config, n, esz)
    least = roofline_time(ops, nbytes, run.kind, "fp32")
    if least is None:
        return None
    return 100.0 * least / (secs / (launches / per_step))


def clip_mfu(run) -> Optional[float]:
    """The whole step's share of the card's dense peak in the
    configuration's precision: the plain forward's FLOPs a clip (frozen in
    the configuration) times the engine's clips served in the window, over
    the window."""
    clips = run.readings.get("clips")
    p = peak(run.kind, run.config["precision"])
    if not clips or p is None:
        return None
    return 100.0 * run.config["flops_per_clip"] * clips / run.window_s / p
