"""The engine's time a batch as the batcher clocks it around predict_packets (host pick, upload, the captured step, the copies back), over the window (BatcherStats.sum_infer_ms / batches)."""

from benchmark.readings import batcher

UNIT = "ms"


def read(run):
    return batcher(run, "sum_infer_ms", "batches")
