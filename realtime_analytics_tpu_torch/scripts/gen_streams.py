"""Generate an N-stream pipeline YAML (32-stream configs by hand are silly).

Usage:
  python -m realtime_analytics_tpu_torch.scripts.gen_streams --n 32 \
      --url-template "rtsp://127.0.0.1:{port}/cam-{i:02d}" --base-port 8554 \
      --out config/pipeline-32.yaml
"""

from __future__ import annotations

import argparse
import sys

import yaml


def build_config(n: int, url_template: str, base_port: int, target_fps: float,
                 synthetic: bool) -> dict:
    streams = []
    for i in range(n):
        if synthetic:
            url = f"synthetic://?width=1920&height=1080&boxes=4&seed={i}"
        else:
            url = url_template.format(i=i, port=base_port + i)
        streams.append(
            {
                "name": f"cam-{i:02d}",
                "url": url,
                "target_fps": target_fps,
                "batch_size": 2,
                "warmup_seconds": 0.0 if synthetic else 2.0,
                "adaptive_fps": True,
                "min_target_fps": min(5.0, target_fps),
                "idle_frame_tolerance": 60,
            }
        )
    return {
        "max_concurrent_streams": max(32, n),
        "stats_interval_seconds": 15,
        "batch_window_ms": 4,
        "streams": streams,
        "detector": {
            "model_path": "models/yolov8n.pt",
            "backend": "jax",
            "model_type": "yolov8",
            "confidence_threshold": 0.25,
            "iou_threshold": 0.45,
            "input_size": [640, 640],
            "max_batch_size": n,
            "batch_buckets": sorted({max(1, n // 4), max(1, n // 2), n}),
            "precision": "bf16",
            "warmup": True,
        },
        "tracker": {"max_age": 30, "max_iou_distance": 0.7, "min_hits": 3},
        "kafka": {
            "enabled": True,
            "transport": "eventbus",
            "bootstrap_servers": "127.0.0.1:9192",
            "topic": "analytics.events",
            "include_frames": False,
        },
        "prometheus": {"enabled": True, "port": 9000},
        "snapshots": {"enabled": False},
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=32)
    p.add_argument("--url-template", default="rtsp://127.0.0.1:{port}/cam-{i:02d}")
    p.add_argument("--base-port", type=int, default=8554)
    p.add_argument("--target-fps", type=float, default=25)
    p.add_argument("--synthetic", action="store_true",
                   help="use synthetic:// sources instead of RTSP")
    p.add_argument("--out", default="-")
    args = p.parse_args(argv)
    cfg = build_config(args.n, args.url_template, args.base_port,
                       args.target_fps, args.synthetic)
    text = yaml.safe_dump(cfg, sort_keys=False)
    if args.out == "-":
        sys.stdout.write(text)
    else:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
