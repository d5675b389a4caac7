"""Seeded 1080p frames: what the footage traffic plays and the checkpoint's
batch norms are set from.

A frame is a scene: a smooth colour field (a 9 x 16 grid of random colours,
bilinear to full size, in 20..120), ``boxes`` solid rectangles of ``sizes`` (8-25%) of
each side in bright colours (120..255), and pixel noise of std 8, as uint8
BGR [N, H, W, 3]. It is made on the device from one ``torch.Generator``, so
the same seed gives the same frames on any card, and copied to the host
once.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

HW = (1080, 1920)


def scene_frames(gen: torch.Generator, n: int, device, hw=HW, boxes: int = 8,
                 field: float = 100.0, noise: float = 8.0, sizes=(0.08, 0.25)) -> torch.Tensor:
    """``n`` scenes of ``hw`` on ``device`` (uint8 [n, H, W, 3]); ``field``
    and ``noise`` 0 give flat scenes, as the cameras' synthetic sources
    render them."""
    h, w = hw
    low = torch.rand(n, 3, 9, 16, generator=gen, device=device)
    x = 20.0 + field * F.interpolate(low, size=hw, mode="bilinear", align_corners=False)
    size = sizes[0] + (sizes[1] - sizes[0]) * torch.rand(n, boxes, 2, generator=gen, device=device)
    corner = torch.rand(n, boxes, 2, generator=gen, device=device) * (1.0 - size)
    colour = 120.0 + 135.0 * torch.rand(n, boxes, 3, generator=gen, device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None] / h
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :] / w
    for b in range(boxes):
        y0, x0 = corner[:, b, 0, None, None], corner[:, b, 1, None, None]
        y1, x1 = y0 + size[:, b, 0, None, None], x0 + size[:, b, 1, None, None]
        inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)  # [n, H, W]
        x = torch.where(inside[:, None], colour[:, b, :, None, None], x)
    x = x + noise * torch.randn(x.shape, generator=gen, device=device)
    return x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).contiguous()
