"""Frames returned by predict_arrays in the window over the window's seconds (host clock)."""

from benchmark.readings import footage_fps as read  # noqa: F401

UNIT = "frames/s"
