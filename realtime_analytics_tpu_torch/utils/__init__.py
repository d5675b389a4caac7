"""Host-side utilities: frame filters, ROI masks, logging helpers."""

from .frame_filter import (  # noqa: F401
    MotionFilter,
    MotionFilterConfig,
    apply_roi,
    downsample,
    roi_mask,
)
