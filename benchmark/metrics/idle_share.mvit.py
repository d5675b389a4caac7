"""1 - the device's merged busy time over the traced span (the window's last seconds) of the MViT cell, in %."""

from benchmark.readings import idle_share as read  # noqa: F401

UNIT = "%"
