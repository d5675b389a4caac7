"""The yardstick's arithmetic: the FLOPs, operations and bytes that the
per-layer readers divide by a time, and the card's peaks.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989 TFLOP/s
in bf16, 67 TFLOP/s in fp32 outside the tensor cores, 3.35 TB/s of HBM3. A
share of a peak is stated only on a card of that name; the run prints the
card's power limit beside it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from .weights import SCALES, make_divisible

PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "fp32": 67e12, "hbm": 3.35e12},
}


def peak(kind: str, what: str) -> Optional[float]:
    return PEAKS.get(kind, {}).get(what)


def stem_widths(scale: str) -> Tuple[int, int]:
    """(c0, c1): the output channels of nodes 0 and 1 at ``scale``."""
    _, width, max_ch = SCALES[scale]
    return (make_divisible(min(64, max_ch) * width), make_divisible(min(128, max_ch) * width))


def stem_work(n: int, h: int, w: int, c0: int, c1: int, esz: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of B3 on [n, h, w, 3]: conv 3 -> c0 (k3 s2) then c0 ->
    c1 (k3 s2), a multiply-add two FLOPs; the input read once and the output
    [n, h/4, w/4, c1] written once, in elements of ``esz`` bytes."""
    flops = 2.0 * n * ((h // 2) * (w // 2) * c0 * 27 + (h // 4) * (w // 4) * c1 * 9 * c0)
    nbytes = float(n * h * w * 3 * esz + n * (h // 4) * (w // 4) * c1 * esz)
    return flops, nbytes


def nms_work(n: int, k: int) -> Tuple[float, float]:
    """(fp32 operations, bytes) of B6's two passes over ``n`` images of
    ``k`` candidates: every pair's IoU test, 12 operations a pair (n k^2 / 2
    pairs); the boxes (16 bytes), the valid flags and the keep flags."""
    return 12.0 * n * k * k / 2.0, float(n * k * (16 + 1 + 1))


def roofline_time(flops: float, nbytes: float, kind: str, dtype: str) -> Optional[float]:
    """The least seconds the card could take: the larger of the operations
    over the dtype's peak and the bytes over the HBM peak."""
    p, hbm = peak(kind, dtype), peak(kind, "hbm")
    if p is None or hbm is None:
        return None
    return max(flops / p, nbytes / hbm)
