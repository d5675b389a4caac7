"""B8 (csrc/attention.cu): its least time an MViTv2 step at the cell's shapes (mvit_counts.py: FLOPs over the bf16 peak, or bytes over HBM's), against its mean device time a step in the trace, in %."""

from benchmark.mvit_counts import attention_roofline as read  # noqa: F401

UNIT = "%"
