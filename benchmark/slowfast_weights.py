"""Seeded checkpoints in PySlowFast's ``model_state`` layout for SlowFast R50.

The layout is the plain reference's (``reference.slowfast.manifest``):
every key and shape of the network the configuration sizes, in its order,
so the benchmark owns the layout it measures. ``seeded_state_dict`` fills
it on the device from one ``torch.Generator`` in two large draws (a normal
and a uniform over every element), then splits and scales them key by
key:

* a conv's weight is He-normal (std ``sqrt(2 / fan_in)``), so a conv and
  its ReLU keep their input's scale;
* a BN's running mean is ``0.1 N``, its running variance in [0.75, 1.25],
  its beta ``0.1 N`` and its gamma in ``GAMMA``, but a bottleneck's last
  (``branch2.c_bn``, which PySlowFast's ``ZERO_INIT_FINAL_BN`` would zero)
  in ``LAST_GAMMA``: each residual branch adds a third of its shortcut's
  scale, so every branch and lateral counts, and the scale grows by a few
  times over the 16 blocks;
* the projection is ``N / sqrt(features)``, its bias ``0.1 N``: logits of a
  few units, no class taking the softmax whole.

The same seed gives the same state on one kind of device.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from .reference.slowfast import manifest

GAMMA = (0.8, 1.2)  # every BN but a bottleneck's last
LAST_GAMMA = (0.2, 0.4)  # branch2.c_bn: the residual branch, live and bounded


def seeded_state_dict(config: Mapping, seed: int, device="cpu") -> Dict[str, torch.Tensor]:
    """A PySlowFast ``model_state`` for the network ``config`` sizes, from
    ``seed``, fp32 on ``device``."""
    shapes = manifest(config)
    sizes = [math.prod(s) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for (key, shape), size in zip(shapes.items(), sizes):
        n, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.long, device=device)
        elif key == "head.projection.weight":
            sd[key] = n * shape[1] ** -0.5
        elif key.endswith(".running_mean") or key.endswith(".bias"):
            sd[key] = 0.1 * n
        elif key.endswith(".running_var"):
            sd[key] = 0.75 + 0.5 * u
        elif key.endswith("bn.weight"):
            lo, hi = LAST_GAMMA if key.endswith(".c_bn.weight") else GAMMA
            sd[key] = lo + (hi - lo) * u
        else:  # a conv's weight
            sd[key] = n * math.sqrt(2.0 / math.prod(shape[1:]))
    return sd
