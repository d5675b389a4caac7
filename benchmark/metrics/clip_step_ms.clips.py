"""The engine's clip step (the mean ``clip_step`` span: the upload, the SlowFast forward, the top-5 and logits coming back) over the traced seconds, in ms."""

UNIT = "ms"


def read(run):
    return run.readings.get("clip_step_ms")
