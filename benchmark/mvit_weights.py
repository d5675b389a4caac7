"""Seeded checkpoints in PySlowFast's ``model_state`` layout for MViTv2.

The layout is the plain reference's (``reference.mvit.manifest``): every
key and shape of the network the configuration sizes, in its order, so the
benchmark owns the layout it measures. ``seeded_state_dict`` fills it on
the device from one ``torch.Generator`` in two large draws (a normal and a
uniform over every element), then splits and scales them key by key:

* every bias (the linears', the patch embedding's, the LayerNorms') is
  ``0.1 N``;
* a LayerNorm's weight is in ``LN_GAMMA``;
* every other tensor (the linears, the patch embedding, the depthwise
  pools, the relative-position tables, the cls token) is ``N / sqrt(fan_in)``
  over all its axes but the first: each linear keeps its input's scale, and
  a relative-position term ``q . R`` of a LayerNormed q is of the order of
  the scaled logits, so the bias moves every softmax (PySlowFast's
  trunc-normal 0.02 init would leave it near zero, and residual pooling,
  the pooled k and v and each block's branches are live as well).

The same seed gives the same state on one kind of device.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch

from .reference.mvit import manifest

LN_GAMMA = (0.8, 1.2)


def seeded_state_dict(config: Mapping, seed: int, device="cpu") -> Dict[str, torch.Tensor]:
    """A PySlowFast MViT ``model_state`` for the network ``config`` sizes,
    from ``seed``, fp32 on ``device``."""
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
        if key.endswith(".bias"):
            sd[key] = 0.1 * n
        elif len(shape) == 1:  # a LayerNorm's weight
            sd[key] = LN_GAMMA[0] + (LN_GAMMA[1] - LN_GAMMA[0]) * u
        else:
            sd[key] = n * math.prod(shape[1:]) ** -0.5
    return sd
