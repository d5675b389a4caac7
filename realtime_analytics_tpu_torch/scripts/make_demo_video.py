"""Generate a demo video for the local/RTSP configs.

The reference bundles ``data/samples/demo.mp4`` as its universal fixture;
this repo synthesizes one instead (moving objects over a structured
background, same generator the synthetic:// stream source uses), so the
ffmpeg-simulator configs work out of the box without binary assets in git.

Usage:
  python -m realtime_analytics_tpu_torch.scripts.make_demo_video \
      [--out data/samples/demo.mp4] [--seconds 10] [--fps 25] \
      [--width 1280] [--height 720]
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="data/samples/demo.mp4")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--fps", type=int, default=25)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--boxes", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    try:
        import cv2
    except ImportError:
        print("cv2 is required to encode video", file=sys.stderr)
        return 1

    from realtime_analytics_tpu_torch.ingest.synthetic import SyntheticSource

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    src = SyntheticSource(
        width=args.width, height=args.height, boxes=args.boxes, seed=args.seed
    )
    fourcc = cv2.VideoWriter_fourcc(*"mp4v")
    writer = cv2.VideoWriter(
        args.out, fourcc, args.fps, (args.width, args.height)
    )
    if not writer.isOpened():
        print(f"could not open VideoWriter for {args.out}", file=sys.stderr)
        return 1
    n = int(args.seconds * args.fps)
    for _ in range(n):
        ok, frame = src.read()
        if not ok:
            break
        writer.write(frame)
    writer.release()
    size = os.path.getsize(args.out)
    print(f"wrote {args.out}: {n} frames @ {args.fps} fps, {size/1e6:.1f} MB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
