"""The engine's host assembly of a call's clips (the mean ``clip_pack`` span: stack, host resize, padding) over the traced seconds, in ms."""

UNIT = "ms"


def read(run):
    return run.readings.get("clip_pack_ms")
