"""Frames the streams read in the window over the frames the cameras offered (cameras x fps x window), in %."""

from benchmark.readings import read_share as read  # noqa: F401

UNIT = "%"
