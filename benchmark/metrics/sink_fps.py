"""Sink events of all streams in the window over the window's seconds (host clock)."""

from benchmark.readings import sink_fps as read  # noqa: F401

UNIT = "frames/s"
