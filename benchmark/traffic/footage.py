"""Recorded footage re-analysed offline: one caller, closed loop.

The mix file gives ``batch`` (frames a call), ``pool`` (distinct frames),
``width`` and ``height``, ``boxes`` (rectangles a scene), ``warm_calls``
and ``check_batches``. Set-up makes ``pool`` seeded scenes
(``frames.scene_frames``) on the device and copies them to the host once,
laid out as a ring of ``pool + batch - 1`` frames so that any ``batch``
consecutive frames are one contiguous array; builds ``TorchYoloEngine``
with the batch as its only bucket, warms it (``warmup`` captures the step)
and makes ``warm_calls`` untimed calls. The window then calls
``predict_arrays`` back to back, each call on the ``batch`` frames that
start at an offset drawn from the seed: every seed plays the same frames in
another order.

Readings: frames returned in the window (a call counts when it returns
before the window closes), calls, frames attempted (every frame handed to a
call in the window) and failed (those of calls that raised); for the check,
``check_batches`` calls drawn from the seed (reservoir sampling), with their
frames by pool index.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def footage(ctx, mix) -> np.ndarray:
    """The ring of seeded scenes, uint8 [pool + batch - 1, H, W, 3] on the host."""
    from benchmark.frames import scene_frames

    gen = torch.Generator(device=ctx.device).manual_seed(ctx.seed + 1)
    hw = (mix["height"], mix["width"])
    ring = np.empty((mix["pool"] + mix["batch"] - 1, *hw, 3), np.uint8)
    for lo in range(0, mix["pool"], 8):
        n = min(8, mix["pool"] - lo)
        ring[lo:lo + n] = scene_frames(gen, n, ctx.device, hw, mix["boxes"]).cpu().numpy()
    ring[mix["pool"]:] = ring[: mix["batch"] - 1]
    return ring


def run(ctx) -> dict:
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine

    mix = ctx.mix
    n, pool = mix["batch"], mix["pool"]
    ring = footage(ctx, mix)
    engine = TorchYoloEngine(ctx.detector_config(ctx.checkpoint(), [n], warmup=False))
    engine.warmup(ring.shape[1:3], buckets=[n])
    rng = np.random.default_rng(ctx.seed)
    for o in rng.integers(0, pool, mix["warm_calls"]):
        engine.predict_arrays(ring[o:o + n])
    ctx.tracer.warm(ctx.device)
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()

    pick = np.random.default_rng(ctx.seed + 2)
    kept = []  # reservoir of (offset, result)
    calls = done = attempted = failed = 0
    t_open = ctx.open_window()
    t_close = ctx.t_close
    now = t_open
    while now < t_close:
        if now >= t_close - ctx.tracer_seconds:
            ctx.tracer.start()
        o = int(rng.integers(0, pool))
        attempted += n
        try:
            res = engine.predict_arrays(ring[o:o + n])
        except RuntimeError:
            failed += n
            now = time.perf_counter()
            continue
        now = time.perf_counter()
        calls += 1
        if now <= t_close:
            done += n
        if len(kept) < mix["check_batches"]:
            kept.append((o, res))
        else:
            j = int(pick.integers(0, calls))
            if j < mix["check_batches"]:
                kept[j] = (o, res)
    ctx.tracer.stop()
    samples = []
    for o, res in kept:
        for i in range(n):
            k = int(res.num_valid[i])
            samples.append(((o + i) % pool, ring[o + i], res.boxes_xyxy[i, :k],
                            res.scores[i, :k], res.class_ids[i, :k]))
    return {"window_s": ctx.seconds, "frames": done, "calls": calls,
            "attempted": attempted, "failed": failed, "batch": n, "samples": samples}
