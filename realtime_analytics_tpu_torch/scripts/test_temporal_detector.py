"""Manual temporal-detector harness (working replacement for the reference's
bit-rotted scripts/test_temporal_detector.py, which crashes on a stale
FramePacket kwarg — SURVEY.md §4.1).

Counterpart of ``realtime_analytics_tpu/scripts/test_temporal_detector.py``
on ``TorchTemporalEngine``: ``--device auto`` (the default) is the card and
raises when none is visible, ``--device cpu`` the CPU. On the card each
clip goes through the clip letterbox (kernel B4).

Feeds frames from a video file, an image directory, or a synthetic source
through a temporal engine and prints per-clip results plus latency stats.

Usage:
  python -m realtime_analytics_tpu_torch.scripts.test_temporal_detector \
      --model-type cnn_lstm --source "synthetic://?frames=64" --frames 64
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Iterator, Tuple

import numpy as np


def iter_frames(source: str, limit: int) -> Iterator[Tuple[int, np.ndarray]]:
    if source.startswith("synthetic://"):
        from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource

        src = SyntheticSource.from_url(source)
        for i in range(limit):
            ok, frame = src.read()
            if not ok:
                return
            yield i, frame
        return
    path = Path(source)
    if path.is_dir():
        import cv2

        files = sorted(
            f for f in path.iterdir() if f.suffix.lower() in (".jpg", ".png", ".jpeg")
        )
        i = 0
        for f in files[:limit]:
            frame = cv2.imread(str(f))
            if frame is None:  # truncated/corrupt image: skip, don't crash
                print(f"warning: could not read {f}, skipping")
                continue
            yield i, frame
            i += 1
        return
    import cv2

    cap = cv2.VideoCapture(str(path))
    i = 0
    while i < limit:
        ok, frame = cap.read()
        if not ok:
            break
        yield i, frame
        i += 1
    cap.release()


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--model-type", default="cnn_lstm",
                   choices=["cnn_lstm", "3d_cnn", "conv_gru", "slow_fast"])
    p.add_argument("--model-path", default="__random__.npz")
    p.add_argument("--source", default="synthetic://?width=640&height=480&boxes=3")
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--sequence-length", type=int, default=16)
    p.add_argument("--sequence-stride", type=int, default=1)
    p.add_argument("--overlap", type=float, default=0.5)
    p.add_argument("--num-classes", type=int, default=400)
    p.add_argument("--warmup", type=int, default=1, help="warmup clips to skip in stats")
    p.add_argument("--device", default="auto",
                   help="auto | cuda | cuda:N (the card; raises without one) | cpu")
    args = p.parse_args(argv)

    from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
    from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
    from realtime_analytics_tpu_torch.types import FramePacket

    cfg = DetectorConfig(
        model_path=args.model_path, model_type=args.model_type, device=args.device,
        sequence_length=args.sequence_length, sequence_stride=args.sequence_stride,
        temporal_overlap=args.overlap, num_action_classes=args.num_classes,
        confidence_threshold=1e-6,
    )
    engine = TorchTemporalEngine(cfg)
    stream = StreamConfig(name="harness", url=args.source)

    latencies = []
    clips = 0
    for i, frame in iter_frames(args.source, args.frames):
        t0 = time.perf_counter()
        dets = engine.predict(FramePacket(stream, frame, i, time.time()))
        dt = (time.perf_counter() - t0) * 1e3
        if dets:
            clips += 1
            if clips > args.warmup:
                latencies.append(engine.last_infer_ms)
            top = dets[0]
            print(
                f"frame {i:4d}: clip [{top.sequence_start_frame}-"
                f"{top.sequence_end_frame}] top action={top.action_label} "
                f"score={top.temporal_score:.4f} ({len(dets)} results, "
                f"{dt:.1f} ms incl. buffering)"
            )
    if latencies:
        arr = np.asarray(latencies)
        eff_fps = 1e3 / arr.mean() * args.sequence_length
        print(
            f"\nclips: {clips}  infer latency avg/min/max: "
            f"{arr.mean():.1f}/{arr.min():.1f}/{arr.max():.1f} ms  "
            f"effective throughput: {eff_fps:.1f} frames/s"
        )
    else:
        print(f"\nclips: {clips} (not enough for stats)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
