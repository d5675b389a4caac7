"""B7 (csrc/epilogue.cu): its bytes a SlowFast step at the cell's shapes over HBM's peak, against its mean device time a step in the trace, in %."""

from benchmark.clip_counts import epilogue_roofline as read  # noqa: F401

UNIT = "%"
