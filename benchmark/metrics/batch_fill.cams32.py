"""The batcher's frames a device batch over its largest bucket, over the window (BatcherStats), in %."""

from benchmark.readings import batcher

UNIT = "%"


def read(run):
    return batcher(run, "sum_batch_size", "batches", 100.0 / run.readings["max_batch"])
