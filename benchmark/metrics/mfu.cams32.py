"""The whole step's share of the card's dense bf16 peak: the plain forward's FLOPs a frame times the frames at the sink in the window, over its seconds, in %."""

from benchmark.readings import mfu, sink_fps

UNIT = "%"


def read(run):
    fps = sink_fps(run)
    return None if fps is None else mfu(run, fps * run.window_s)
