#!/usr/bin/env python
"""Detection-accuracy evaluation CLI (mAP@[.5:.95]) — the analog of
Ultralytics ``val`` on the port's serving engine.

Counterpart of ``realtime_analytics_tpu/scripts/eval_detections.py``: the
same modes and flags, through ``TorchYoloEngine``. ``--device`` overrides
the config's ``device``; without ``--config`` the default ``auto`` is the
card (and raises when none is visible); ``--device cpu`` runs on the CPU.

Dataset modes:
  --synthetic N           N labeled frames from the deterministic synthetic
                          source (self-contained sanity/regression mode)
  --images DIR --labels DIR
                          YOLO-format txt labels (class cx cy w h, normalized)
  --coco FILE --images DIR
                          COCO annotation JSON (bbox = [x, y, w, h])

Examples:
  realtime-analytics-torch-eval --model-path yolov8n.pt --images val/img \\
      --labels val/labels --conf 0.001
  realtime-analytics-torch-eval --model-path yolov8n.pt --synthetic 64
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Iterator, List, Optional, Tuple

import numpy as np

from ..config import DetectorConfig, load_config
from ..eval.detection_metrics import DetectionSample, evaluate_detections

logger = logging.getLogger("eval")


def _iter_synthetic(n: int, hw: Tuple[int, int]) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    from ..ingest.synthetic import SyntheticSource

    src = SyntheticSource(width=hw[1], height=hw[0], boxes=4, seed=0)
    for _ in range(n):
        ok, frame, gt, cls = src.read_labeled()
        if not ok:
            return
        yield frame, gt, cls.astype(int)


def _read_image(path: str) -> Optional[np.ndarray]:
    try:
        import cv2

        img = cv2.imread(path)  # BGR, matching the serving contract
        if img is not None:
            return img
    except ImportError:
        pass
    try:  # PPM/PNG via numpy-only fallbacks are not worth carrying: use npy
        if path.endswith(".npy"):
            return np.load(path)
    except Exception:  # noqa: BLE001
        return None
    return None


_IMG_EXT = (".jpg", ".jpeg", ".png", ".bmp", ".npy")


def _iter_yolo(images_dir: str, labels_dir: str) -> Iterator:
    names = sorted(
        f for f in os.listdir(images_dir) if f.lower().endswith(_IMG_EXT)
    )
    for name in names:
        img = _read_image(os.path.join(images_dir, name))
        if img is None:
            logger.warning("unreadable image: %s", name)
            continue
        h, w = img.shape[:2]
        label_path = os.path.join(
            labels_dir, os.path.splitext(name)[0] + ".txt"
        )
        boxes, classes = [], []
        if os.path.exists(label_path):
            for line in open(label_path, encoding="utf-8"):
                parts = line.split()
                if len(parts) < 5:
                    continue
                cid, cx, cy, bw, bh = (float(v) for v in parts[:5])
                boxes.append(
                    [
                        (cx - bw / 2) * w,
                        (cy - bh / 2) * h,
                        (cx + bw / 2) * w,
                        (cy + bh / 2) * h,
                    ]
                )
                classes.append(int(cid))
        yield img, np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(
            classes, int
        )


def _iter_coco(coco_json: str, images_dir: str) -> Iterator:
    with open(coco_json, encoding="utf-8") as fh:
        coco = json.load(fh)
    # COCO category ids are sparse (1..90 with gaps); map to the contiguous
    # 0..79 training indices the checkpoints emit
    cat_ids = sorted(c["id"] for c in coco.get("categories", []))
    cat_to_idx = {cid: i for i, cid in enumerate(cat_ids)}
    by_image = {}
    for ann in coco.get("annotations", []):
        if ann.get("iscrowd"):
            continue
        x, y, w, h = ann["bbox"]
        by_image.setdefault(ann["image_id"], []).append(
            (cat_to_idx.get(ann["category_id"], -1), [x, y, x + w, y + h])
        )
    for im in coco.get("images", []):
        path = os.path.join(images_dir, im["file_name"])
        img = _read_image(path)
        if img is None:
            logger.warning("unreadable image: %s", im["file_name"])
            continue
        anns = by_image.get(im["id"], [])
        boxes = np.asarray([b for _, b in anns], np.float32).reshape(-1, 4)
        classes = np.asarray([c for c, _ in anns], int)
        yield img, boxes, classes


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", help="pipeline YAML: uses its detector section")
    ap.add_argument("--model-path", help="checkpoint (overrides --config)")
    # default None so a --config's model_type is not silently overridden
    ap.add_argument("--model-type", default=None,
                    help="yolov8|yolov5 (default: from --config, else yolov8)")
    ap.add_argument("--input-size", type=int, nargs=2, default=None,
                    metavar=("H", "W"))
    ap.add_argument("--precision", default=None,
                    choices=("fp32", "bf16", "int8"))
    ap.add_argument("--conf", type=float, default=0.001,
                    help="confidence floor for eval (default 0.001 — "
                         "mAP needs the low-confidence tail)")
    ap.add_argument("--iou-nms", type=float, default=0.7,
                    help="NMS IoU (val-style default 0.7)")
    ap.add_argument("--max-det", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--synthetic", type=int, default=0, metavar="N")
    ap.add_argument("--synthetic-hw", type=int, nargs=2, default=(480, 854))
    ap.add_argument("--images", help="images directory")
    ap.add_argument("--labels", help="YOLO-format labels directory")
    ap.add_argument("--coco", help="COCO annotations JSON")
    ap.add_argument("--json", action="store_true", help="print JSON only")
    ap.add_argument("--device", default=None,
                    help="auto | cuda | cuda:N | cpu (default: from --config, "
                         "else auto: the card)")
    return ap


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(message)s")

    if args.config:
        det_cfg = load_config(args.config).detector
    else:
        det_cfg = DetectorConfig(model_path=args.model_path or "yolov8n.pt")
    if args.model_path:
        det_cfg.model_path = args.model_path
    if args.model_type:
        det_cfg.model_type = args.model_type
    if args.input_size:
        det_cfg.input_size = list(args.input_size)
    if args.precision:
        det_cfg.precision = args.precision
    det_cfg.confidence_threshold = args.conf
    det_cfg.iou_threshold = args.iou_nms
    det_cfg.max_detections = args.max_det
    det_cfg.max_batch_size = max(det_cfg.max_batch_size, args.batch)
    det_cfg.warmup = False
    if args.device:
        det_cfg.device = args.device

    from ..engine.detector import TorchYoloEngine

    engine = TorchYoloEngine(det_cfg)

    if args.synthetic:
        it = _iter_synthetic(args.synthetic, tuple(args.synthetic_hw))
    elif args.coco:
        if not args.images:
            print("--coco requires --images", file=sys.stderr)
            return 2
        it = _iter_coco(args.coco, args.images)
    elif args.images and args.labels:
        it = _iter_yolo(args.images, args.labels)
    else:
        print("need --synthetic N, --images+--labels, or --coco+--images",
              file=sys.stderr)
        return 2

    samples: List[DetectionSample] = []
    pending: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def flush() -> None:
        if not pending:
            return
        by_shape = {}
        for idx, (img, _, _) in enumerate(pending):
            by_shape.setdefault(img.shape[:2], []).append(idx)
        for idxs in by_shape.values():
            frames = np.stack([pending[i][0] for i in idxs])
            res = engine.predict_arrays(frames)
            for j, i in enumerate(idxs):
                n = int(res.num_valid[j])
                _, gt, cls = pending[i]
                samples.append(
                    DetectionSample(
                        det_boxes=res.boxes_xyxy[j, :n],
                        det_scores=res.scores[j, :n],
                        det_classes=res.class_ids[j, :n].astype(int),
                        gt_boxes=gt,
                        gt_classes=cls,
                    )
                )
        pending.clear()

    for img, gt, cls in it:
        pending.append((img, gt, cls))
        if len(pending) >= args.batch:
            flush()
    flush()

    if not samples:
        print("no evaluable images", file=sys.stderr)
        return 1
    metrics = evaluate_detections(samples)
    if args.json:
        print(json.dumps(metrics))
    else:
        print(json.dumps({k: v for k, v in metrics.items() if k != "per_class"},
                         indent=2))
        rows = sorted(metrics["per_class"].items())
        for cid, m in rows[:30]:
            print(f"  class {cid:>3}: AP={m['ap']:.4f} AP50={m['ap50']:.4f} "
                  f"n_gt={m['n_gt']}")
        if len(rows) > 30:
            print(f"  ... {len(rows) - 30} more classes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
