"""The MViT cell's arithmetic: B8's work in an MViTv2 step and the reader
that divides it by B8's time in the trace. Peaks are ``counts.py``'s.

An MViTv2 step at batch N runs B8 once a block (16 launches for MViTv2-S),
on the token grids ``reference/mvit.py`` derives from the configuration
(``token_grids``; cls added to each). A block of ``heads`` heads of head
dim D with Nq query and Nk key tokens does ``4 heads Nq Nk D`` FLOPs a
clip (QK^T and PV, two FLOPs a multiply-add) and moves q, k, v and the
output once each (``2 heads (Nq + Nk) D`` values) and the three per-query
tables once (``heads (Nq - 1) (k_t + k_h + k_w)`` values): the least any
implementation of the same attention reads and writes. The counts do not
depend on how the work is done, so the same work is read whatever
implements it later.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from .counts import roofline_time
from .reference.mvit import blocks, token_grids

ATTENTION_KERNEL = "rel_pos_attention_kernel"


def attention_calls(config: Dict) -> List[Tuple[int, int, int, int, int]]:
    """(heads, head dim, Nq, Nk, k_t + k_h + k_w) of each block's attention,
    in block order."""
    return [(g["heads"], b["dim_out"] // b["heads"], 1 + math.prod(g["q"]),
             1 + math.prod(g["kv"]), sum(g["kv"]))
            for b, g in zip(blocks(config), token_grids(config))]


def call_work(heads: int, d: int, nq: int, nk: int, rel: int, batch: int,
              esz: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one block's attention over ``batch`` clips, in
    elements of ``esz`` bytes."""
    return (4.0 * batch * heads * nq * nk * d,
            float(batch * heads * (2 * (nq + nk) * d + (nq - 1) * rel) * esz))


def attention_work(config: Dict, batch: int, esz: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the attentions of one step of ``batch`` clips."""
    work = [call_work(*call, batch, esz) for call in attention_calls(config)]
    return sum(f for f, _ in work), sum(b for _, b in work)


def attention_roofline(run) -> Optional[float]:
    """B8's share of its roofline: its least time a step (the larger of its
    FLOPs over the bf16 peak and its bytes over HBM's) over its mean device
    time a step in the trace (launches / 16 steps); None under one step's
    launches."""
    n = run.readings.get("batch")
    secs = launches = 0
    for kernel, (s, k) in run.trace.get("kernels", {}).items():
        if ATTENTION_KERNEL in kernel:
            secs, launches = secs + s, launches + k
    per_step = len(attention_calls(run.config))
    if not n or launches < per_step:
        return None
    esz = 2 if run.config["precision"] == "bf16" else 4
    flops, nbytes = attention_work(run.config, n, esz)
    least = roofline_time(flops, nbytes, run.kind, run.config["precision"])
    if least is None:
        return None
    return 100.0 * least / (secs / (launches / per_step))
