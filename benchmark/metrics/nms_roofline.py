"""B6 (csrc/nms.cu): its roofline time (pairs x 12 fp32 operations) over the device time of its two passes a step in the trace, in %."""

from benchmark.readings import nms_roofline as read  # noqa: F401

UNIT = "%"
