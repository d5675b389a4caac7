"""B3 (csrc/stem.cu): its roofline time at the cell's batch and stem widths over its mean device time a launch in the trace, in %.

It reads a cell of one batch size whose model runs B3: a footage cell of
YOLOv8n (YOLOv8l's stem runs as cuDNN convs). No cell lists it yet."""

from benchmark.readings import stem_roofline as read  # noqa: F401

UNIT = "%"
