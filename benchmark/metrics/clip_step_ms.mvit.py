"""The engine's clip step (the mean ``clip_step`` span: the upload, the MViTv2 forward, the top-5 and logits coming back) over the traced seconds of the MViT cell, in ms."""

UNIT = "ms"


def read(run):
    return run.readings.get("clip_step_ms")
