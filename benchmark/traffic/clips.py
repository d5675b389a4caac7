"""Recorded footage reviewed offline as clips: one caller, closed loop.

The mix file gives ``batch`` (clips a call: one a camera of a site),
``pool`` (frames in the ring), ``width`` and ``height`` (the frames' size,
decoded at the model's crop as PySlowFast's test loader hands clips over,
so the step resizes nothing), ``boxes`` (moving rectangles), ``warm_calls``
and ``check_batches``. The clip length and its stride are the
configuration's (``num_frames``, ``sampling_rate``): a clip is
``num_frames`` frames taken every ``sampling_rate`` from a window of
``num_frames * sampling_rate``.

Set-up renders the ring on the device from the seed (``footage``: a smooth
colour field, ``boxes`` rectangles on periodic paths, pixel noise; the ring
closes on itself, so a clip may wrap around it) and copies it to the host
once, as ``FramePacket``s of ``batch`` cameras that share its frames; builds
``TorchTemporalEngine`` with ``batch`` as its only bucket, warms it and
makes ``warm_calls`` untimed calls. The window then calls ``predict_clips``
back to back with ``return_logits``, each call on one clip a camera, each
clip starting at an offset drawn from the seed.

Readings: the footage the clips returned in the window cover (``frames``:
clips x ``num_frames`` x ``sampling_rate``; a call counts when it returns
before the window closes), ``clips`` (the engine's ``clips`` counter over
the same calls), calls, clips attempted (every clip handed to a call in the
window) and failed (those of calls that raised); the mean ``clip_pack`` and
``clip_step`` spans of the traced seconds (None without a trace); for the
check, ``check_batches`` calls drawn from the seed (reservoir sampling),
each clip with its frames and the logits served for it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn.functional as F


def footage(ctx, mix) -> np.ndarray:
    """The ring of ``pool`` frames, uint8 [pool, H, W, 3] BGR on the host:
    a 9 x 16 field of colours in 20..120, ``boxes`` rectangles (8-25% of
    each side, 120..255) each moving on an ellipse it closes once or twice
    over the ring, pixel noise of std 8."""
    dev = ctx.device
    gen = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    h, w, n, k = mix["height"], mix["width"], mix["pool"], mix["boxes"]
    low = torch.rand(1, 3, 9, 16, generator=gen, device=dev)
    field = 20.0 + 100.0 * F.interpolate(low, size=(h, w), mode="bilinear", align_corners=False)
    size = 0.08 + 0.17 * torch.rand(k, 2, generator=gen, device=dev)
    centre = 0.25 + 0.5 * torch.rand(k, 2, generator=gen, device=dev)
    radius = 0.25 * torch.rand(k, 2, generator=gen, device=dev)
    phase = 2 * math.pi * torch.rand(k, generator=gen, device=dev)
    turns = torch.randint(1, 3, (k,), generator=gen, device=dev).float()
    colour = 120.0 + 135.0 * torch.rand(k, 3, generator=gen, device=dev)
    t = torch.arange(n, device=dev, dtype=torch.float32) / n
    ys = torch.arange(h, device=dev, dtype=torch.float32)[None, :, None] / h
    xs = torch.arange(w, device=dev, dtype=torch.float32)[None, None, :] / w
    ring = np.empty((n, h, w, 3), np.uint8)
    for lo in range(0, n, 64):
        tt = t[lo:lo + 64]
        x = field.expand(len(tt), -1, -1, -1)
        for b in range(k):
            angle = 2 * math.pi * turns[b] * tt + phase[b]  # [frames]
            y0 = (centre[b, 0] + radius[b, 0] * torch.sin(angle) - size[b, 0] / 2)[:, None, None]
            x0 = (centre[b, 1] + radius[b, 1] * torch.cos(angle) - size[b, 1] / 2)[:, None, None]
            inside = (ys >= y0) & (ys < y0 + size[b, 0]) & (xs >= x0) & (xs < x0 + size[b, 1])
            x = torch.where(inside[:, None], colour[b, :, None, None], x)
        x = x + 8.0 * torch.randn(x.shape, generator=gen, device=dev)
        ring[lo:lo + len(tt)] = x.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1).cpu().numpy()
    return ring


def span_ms(name: str):
    """The mean of the traced ``name`` spans, in ms; None where there are none."""
    from realtime_analytics_tpu_torch.telemetry import spans

    got = spans.LOG.spans(name)
    return sum(s.end_ns - s.start_ns for s in got) / len(got) / 1e6 if got else None


def run(ctx) -> dict:
    from realtime_analytics_tpu_torch.config import StreamConfig
    from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
    from realtime_analytics_tpu_torch.types import FramePacket

    mix, cfg = ctx.mix, ctx.config
    n, pool = mix["batch"], mix["pool"]
    t_len, stride = cfg["num_frames"], cfg["sampling_rate"]
    engine = TorchTemporalEngine(ctx.detector_config(ctx.checkpoint(), [n], warmup=False))
    ring = footage(ctx, mix)
    cams = [[FramePacket(StreamConfig(name=f"cam-{c:02d}"), ring[j], j, j / 30.0)
             for j in range(pool)] for c in range(n)]
    steps = stride * np.arange(t_len)

    def call(offsets):
        seqs = [[cams[c][j] for j in (o + steps) % pool] for c, o in enumerate(offsets)]
        return engine.predict_clips(seqs, return_logits=True)[1]

    engine.warmup(ring.shape[1:3], buckets=[n])
    rng = np.random.default_rng(ctx.seed)
    for _ in range(mix["warm_calls"]):
        call(rng.integers(0, pool, n))
    ctx.tracer.warm(ctx.device)
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()

    pick = np.random.default_rng(ctx.seed + 2)
    kept = []  # reservoir of (offsets, logits)
    calls = done = attempted = failed = 0
    clips0 = clips = engine.stats.clips
    t_open = ctx.open_window()
    t_close = ctx.t_close
    now = t_open
    while now < t_close:
        if now >= t_close - ctx.tracer_seconds:
            ctx.tracer.start()
        offsets = rng.integers(0, pool, n)
        attempted += n
        try:
            logits = call(offsets)
        except RuntimeError:
            failed += n
            now = time.perf_counter()
            continue
        now = time.perf_counter()
        calls += 1
        if now <= t_close:
            done += n
            clips = engine.stats.clips
        if len(kept) < mix["check_batches"]:
            kept.append((offsets, logits))
        else:
            j = int(pick.integers(0, calls))
            if j < mix["check_batches"]:
                kept[j] = (offsets, logits)
    ctx.tracer.stop()
    samples = [(int(o), ring[(o + steps) % pool], logits[c])
               for offsets, logits in kept for c, o in enumerate(offsets)]
    return {"window_s": ctx.seconds, "frames": done * t_len * stride, "clips": clips - clips0,
            "calls": calls, "attempted": attempted, "failed": failed, "batch": n,
            "clip_pack_ms": span_ms("clip_pack"), "clip_step_ms": span_ms("clip_step"),
            "samples": samples}
