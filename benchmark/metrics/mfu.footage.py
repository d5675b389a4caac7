"""The whole step's share of the card's dense bf16 peak over the frames predict_arrays returned in the window, in %."""

from benchmark.readings import mfu

UNIT = "%"


def read(run):
    return mfu(run, run.readings.get("frames"))
