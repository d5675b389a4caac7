"""The whole MViTv2 step's share of the card's dense bf16 peak: the plain forward's FLOPs a clip (frozen in the configuration) times the engine's clips served in the window, over the window, in %."""

from benchmark.clip_counts import clip_mfu as read  # noqa: F401

UNIT = "%"
