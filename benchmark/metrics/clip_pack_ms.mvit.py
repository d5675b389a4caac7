"""The engine's host assembly of a call's clips (the mean ``clip_pack`` span: the native gather into the pinned staging buffer) over the traced seconds of the MViT cell, in ms."""

UNIT = "ms"


def read(run):
    return run.readings.get("clip_pack_ms")
