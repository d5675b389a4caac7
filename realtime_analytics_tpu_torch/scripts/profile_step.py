"""Where the time of one detection step goes, on the card.

    python -m realtime_analytics_tpu_torch.scripts.profile_step \\
        [--batch 32] [--reps 20] [--trace-steps 5] [--conf 0.25] \\
        [--precision bf16|int8] [--out profile_step.json]

Builds the main path's engine (YOLOv8n, 640 input, bf16 or the native int8
of ``--precision int8``, one bucket of ``--batch``, seeded synthetic
weights), feeds it ``--batch`` synthetic 1080p frames (an exact 3x host
pick, the selected step) and reports:

1. ``stages``: the step cut into its stages on the host clock, each ending
   in a synchronise (median of ``--reps``): host pick, upload, pad + cast,
   forward (stem, backbone, neck, head and decode), select (threshold and
   NMS), un-letterbox and download;
2. ``step``: the whole step (``predict_arrays``, which replays the step
   captured as a CUDA graph: ``engine/graphs.py``) without those cuts,
   median, and ``eager_step``: the same with the eager step called in its
   place (``eager_predict``);
3. ``concurrent``: ``--depth`` threads calling ``predict_arrays`` at once, as
   the batcher's ``pipeline_depth`` workers do: the median call and the
   frames per second of all threads together;
4. ``contended``: the step while a thread beside it runs pure Python, as
   the pipeline's event loop does, at the default GIL switch interval and
   at a 20x shorter one; ``eager_contended`` the eager step so (a quarter
   of the calls: each eager call takes the GIL back some 300 times);
5. ``trace``: a ``torch.profiler`` window over ``--trace-steps`` steps: the
   device's busy time (kernels and copies, overlaps merged) and its idle
   share of the window, device time by kernel name per step (the 25
   largest, and under ``port_kernels_ms_per_step`` each hand-written kernel
   of ``csrc/`` by its function name, the two stem kernels apart; CUPTI
   reports a replayed graph's kernels one by one), the host calls that wait
   for the device per step, the graph launches per step, and the CUDA
   runtime calls inside the replays (``captured_step`` ranges): one
   ``cudaGraphLaunch`` and no wait.

It needs a CUDA card and fails without one. Every number names the card
and its power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import threading
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

STAGES = ("host_pick", "upload", "pad_cast", "forward", "select_nms",
          "unletterbox_download")
# the __global__ functions of csrc/*.cu, as they appear in a trace
PORT_KERNELS = ("row_gather_kernel", "decode_v8_kernel", "stem_mma_kernel",
                "stem_general_kernel", "letterbox_kernel", "nms_mask_kernel",
                "nms_chain_kernel", "conv_epilogue_kernel")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpyAsync", "cudaMemcpy")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def build_engine(batch: int, conf: float, precision: str = "bf16"):
    from ..config import DetectorConfig
    from ..engine.detector import TorchYoloEngine
    from ..models.weights import synthetic_params
    from ..models.yolo import build_yolo

    cfg = DetectorConfig(
        model_path="profile-seeded-weights", device="cuda", precision=precision,
        confidence_threshold=conf, warmup=False, input_size=[640, 640],
        max_batch_size=batch, batch_buckets=[batch],
    )
    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)
    return TorchYoloEngine(cfg, params=params)


def synthetic_frames(batch: int) -> np.ndarray:
    from ..ingest.synthetic import SyntheticSource

    return np.stack([
        SyntheticSource(width=1920, height=1080, boxes=4, seed=i).read()[1]
        for i in range(batch)
    ])


def stage_times(eng, frames: np.ndarray, reps: int) -> dict:
    from ..ops.boxes import unletterbox_boxes
    from ..ops.preprocess import letterbox_spec

    src_hw = frames.shape[1:3]
    spec = letterbox_spec(src_hw, eng.input_hw)
    rows = defaultdict(list)
    sync = torch.cuda.synchronize
    for _ in range(reps + 2):  # the first two settle allocator and plans
        with torch.inference_mode():
            t = [time.perf_counter()]
            sel, selected = eng.host_prepare(frames, src_hw)
            assert selected, "the 1080p -> 640 step must be the selected step"
            t.append(time.perf_counter())
            x8 = torch.from_numpy(sel).to(eng.device)
            sync()
            t.append(time.perf_counter())
            x = eng._pad_cast(x8, spec)
            sync()
            t.append(time.perf_counter())
            out = eng._forward_selected(x)
            sync()
            t.append(time.perf_counter())
            b, s, c, n = eng._final_select(out)
            sync()
            t.append(time.perf_counter())
            b = unletterbox_boxes(b, spec.scale, spec.pad_left, spec.pad_top,
                                  spec.src_h, spec.src_w)
            _ = [v.cpu().numpy() for v in (b, s, c, n)]
            t.append(time.perf_counter())
        for name, t0, t1 in zip(STAGES, t, t[1:]):
            rows[name].append((t1 - t0) * 1e3)
    return {name: statistics.median(v[2:]) for name, v in rows.items()}


def eager_predict(eng, frames: np.ndarray) -> list:
    """``predict_arrays`` with the eager step called in place of the cached
    one: host pick, upload, the step, the copies back."""
    src_hw = frames.shape[1:3]
    host, selected = eng.host_prepare(frames, src_hw)
    fn = eng.step_for(len(host), src_hw, selected)[1]
    with torch.inference_mode():
        return [t.cpu().numpy() for t in fn(torch.from_numpy(host).to(eng.device))]


def step_times(eng, frames: np.ndarray, reps: int, predict=None) -> list:
    predict = predict or eng.predict_arrays
    predict(frames)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        predict(frames)
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def concurrent_times(eng, frames: np.ndarray, depth: int, calls: int) -> dict:
    lat: list = []
    errors: list = []

    def work():
        try:
            for _ in range(calls):
                t0 = time.perf_counter()
                eng.predict_arrays(frames)
                lat.append((time.perf_counter() - t0) * 1e3)
        except Exception as exc:  # noqa: BLE001 — re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=work) for _ in range(depth)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return dict(depth=depth, calls=depth * calls, call_ms_median=statistics.median(lat),
                frames_per_s=depth * calls * len(frames) / wall)


def contended_times(eng, frames: np.ndarray, calls: int, predict=None) -> dict:
    """The step while another thread runs pure Python, as the pipeline's
    event loop does beside the batcher's workers: at the interpreter's
    default GIL switch interval and at a 20x shorter one. A PyTorch call
    may drop the GIL (a wait for the card always does), and taking it back
    can cost up to one switch interval."""
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            sum(range(1000))

    out = {}
    default = sys.getswitchinterval()
    try:
        for interval in (default, default / 20):
            sys.setswitchinterval(interval)
            th = threading.Thread(target=spin)
            th.start()
            try:
                times = step_times(eng, frames, calls, predict)
            finally:
                stop.set()
                th.join()
                stop.clear()
            out[f"switch_{interval * 1e3:g}ms"] = dict(
                call_ms_median=statistics.median(times), call_ms_max=max(times))
    finally:
        sys.setswitchinterval(default)
    return out


def _merged_span(intervals) -> float:
    total, end = 0.0, -float("inf")
    for a, b in sorted(intervals):
        if a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def trace(eng, frames: np.ndarray, steps: int, predict=None) -> dict:
    """The profiler window of ``steps`` calls of ``predict`` (by default
    ``eng.predict_arrays``; ``lambda f: eager_predict(eng, f)`` for the
    eager step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    predict = predict or eng.predict_arrays
    predict(frames)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            predict(frames)
        torch.cuda.synchronize()
    events = list(prof.events())
    dev = [e for e in events if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    window = (max(e.time_range.end for e in events)
              - min(e.time_range.start for e in events))
    busy = _merged_span((e.time_range.start, e.time_range.end) for e in dev)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += e.time_range.end - e.time_range.start
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:25]
    port = {}
    for kernel in PORT_KERNELS:
        hits = [v for name, v in by_name.items() if kernel in name]
        if hits:
            port[kernel] = dict(ms=sum(us for us, _ in hits) / 1e3 / steps,
                                per_step=sum(cnt for _, cnt in hits) / steps)
    host_waits = defaultdict(int)
    for e in events:
        if e.device_type == DeviceType.CPU and e.name in SYNC_CALLS:
            host_waits[e.name] += 1
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    replays = [e for e in cpu if e.name == "captured_step"]
    in_replay = defaultdict(int)
    for r in replays:
        for e in cpu:
            if (e.name.startswith("cuda") and e.thread == r.thread
                    and r.time_range.start <= e.time_range.start <= r.time_range.end):
                in_replay[e.name] += 1
    return dict(
        steps=steps, window_ms=window / 1e3, device_busy_ms=busy / 1e3,
        device_idle_share=1.0 - busy / window,
        device_ms_per_step=busy / 1e3 / steps,
        kernels_per_step=len(dev) / steps,
        top_device_ms_per_step=[
            dict(name=name[:120], ms=us / 1e3 / steps, per_step=cnt / steps)
            for name, (us, cnt) in top
        ],
        port_kernels_ms_per_step=port,
        host_waits_per_step={k: v / steps for k, v in host_waits.items()},
        graph_launches_per_step=sum(e.name == "cudaGraphLaunch" for e in cpu) / steps,
        replays_per_step=len(replays) / steps,
        runtime_calls_in_replay_per_step={k: v / steps for k, v in in_replay.items()},
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace-steps", type=int, default=5)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--conf", type=float, default=0.25)
    ap.add_argument("--precision", choices=("bf16", "int8"), default="bf16")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_step: no CUDA card visible — this measurement runs on the card",
              file=sys.stderr)
        return 1
    card = card_line()
    eng = build_engine(args.batch, args.conf, args.precision)
    frames = synthetic_frames(args.batch)
    stages = stage_times(eng, frames, args.reps)
    steps = step_times(eng, frames, args.reps)
    eager = step_times(eng, frames, args.reps, lambda f: eager_predict(eng, f))
    result = dict(
        card=card, batch=args.batch, conf=args.conf, precision=args.precision,
        stages_ms=stages, stages_sum_ms=sum(stages.values()),
        step_ms_median=statistics.median(steps), step_ms_min=min(steps),
        eager_step_ms_median=statistics.median(eager), eager_step_ms_min=min(eager),
        frames_per_s=args.batch / statistics.median(steps) * 1e3,
        concurrent=concurrent_times(eng, frames, args.depth, args.reps),
        contended=contended_times(eng, frames, args.reps),
        eager_contended=contended_times(eng, frames, max(2, args.reps // 4),
                                        lambda f: eager_predict(eng, f)),
        trace=trace(eng, frames, args.trace_steps),
        eager_trace=trace(eng, frames, args.trace_steps, lambda f: eager_predict(eng, f)),
    )
    text = json.dumps(result, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
