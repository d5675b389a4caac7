"""Per-frame host-side filters: motion gating, ROI masks, downsampling.

Contract of the reference ``utils/frame_filter.py``:
  * motion: gray -> (5,5) Gaussian blur -> absdiff vs previous -> binary
    threshold at 25 -> fraction of changed pixels >= threshold; the first
    frame always processes;
  * ROI: polygons are *masked* (pixels outside all polygons blacked out),
    not cropped;
  * downsample: linear resize by a scale factor.

The ROI mask is precomputed once per stream (the reference re-rasterizes the
polygons every frame, frame_filter.py:43-50) — same output, ~free per frame.
cv2 is used when present; NumPy fallbacks keep tests hermetic.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False


@dataclass
class MotionFilterConfig:
    enable: bool = False
    history: int = 5
    threshold: float = 0.02  # fraction of pixels changed
    blur_kernel: Tuple[int, int] = (5, 5)


class MotionFilter:
    """Frame-difference motion gate."""

    def __init__(self, config: MotionFilterConfig):
        self.config = config
        self.previous_gray: Optional[np.ndarray] = None

    def should_process(self, frame: np.ndarray) -> bool:
        if not self.config.enable:
            return True
        gray = _to_gray(frame)
        gray = _blur(gray, self.config.blur_kernel)
        if self.previous_gray is None or self.previous_gray.shape != gray.shape:
            self.previous_gray = gray
            return True
        diff = np.abs(gray.astype(np.int16) - self.previous_gray.astype(np.int16))
        motion_ratio = float(np.count_nonzero(diff > 25)) / float(diff.size)
        self.previous_gray = gray
        return motion_ratio >= self.config.threshold

    def reset(self) -> None:
        self.previous_gray = None


def _to_gray(frame: np.ndarray) -> np.ndarray:
    if frame.ndim == 2:
        return frame
    if _HAS_CV2:
        return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
    # BT.601 luma over BGR
    f = frame.astype(np.float32)
    return (0.114 * f[..., 0] + 0.587 * f[..., 1] + 0.299 * f[..., 2]).astype(np.uint8)


def _blur(gray: np.ndarray, kernel: Tuple[int, int]) -> np.ndarray:
    if _HAS_CV2:
        return cv2.GaussianBlur(gray, kernel, 0)
    return gray  # fallback: skip blur (only affects sensitivity slightly)


def roi_mask(
    shape_hw: Tuple[int, int], polygons: Sequence[Sequence[Tuple[int, int]]]
) -> np.ndarray:
    """Rasterize ROI polygons to a uint8 {0,1} mask of the frame shape."""
    mask = np.zeros(shape_hw, dtype=np.uint8)
    if _HAS_CV2:
        for polygon in polygons:
            pts = np.asarray(polygon, dtype=np.int32)
            cv2.fillPoly(mask, [pts], 1)
        return mask
    # NumPy even-odd rasterization fallback
    h, w = shape_hw
    ys, xs = np.mgrid[0:h, 0:w]
    for polygon in polygons:
        pts = np.asarray(polygon, dtype=np.float64)
        inside = np.zeros(shape_hw, dtype=bool)
        n = len(pts)
        for i in range(n):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % n]
            cond = (ys >= min(y0, y1)) & (ys < max(y0, y1))
            # signed denominator: edges with y1 < y0 must keep their slope
            x_int = x0 + (ys - y0) * (x1 - x0) / (y1 - y0) if y1 != y0 else x0
            inside ^= cond & (xs < x_int)
        mask |= inside.astype(np.uint8)
    return mask


def apply_roi(
    frame: np.ndarray,
    polygons: Optional[Sequence[Sequence[Tuple[int, int]]]],
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Black out everything outside the ROI polygons (masking, not cropping)."""
    if mask is None:
        if not polygons:
            return frame
        mask = roi_mask(frame.shape[:2], polygons)
    return frame * mask[..., None]


def downsample(frame: np.ndarray, scale: float) -> np.ndarray:
    if scale >= 0.999:
        return frame
    h, w = frame.shape[:2]
    new_w, new_h = int(w * scale), int(h * scale)
    if _HAS_CV2:
        return cv2.resize(frame, (new_w, new_h), interpolation=cv2.INTER_LINEAR)
    ys = (np.arange(new_h) / scale).astype(np.int32).clip(0, h - 1)
    xs = (np.arange(new_w) / scale).astype(np.int32).clip(0, w - 1)
    return frame[ys][:, xs]
