"""p99 of the latency of every frame whose sink event fell in the window, from its read off the camera to that event (host clock), at saturation: recorded, not judged."""

from benchmark.readings import latency_ms

UNIT = "ms"


def read(run):
    return latency_ms(run, 99)
