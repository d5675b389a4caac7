"""The YOLOv8 detectors: what the benchmark does for a configuration whose
``kind`` is ``yolov8``.

* ``checkpoint(ctx)``: seeded weights in the published Ultralytics layout
  (``weights.py``), made on the device from ``ctx.seed`` by the
  configuration's ``scale``; their fp32 tensors stay on the host as
  ``ctx.state_dict`` for the reference, and the checkpoint goes to the work
  directory;
* ``detector_config(ctx, model_path, buckets, warmup)``: the program's
  ``DetectorConfig`` for ``TorchYoloEngine``, from the configuration's
  sizes and serving thresholds;
* ``check(config, state_dict, samples, device)``: served detections against
  the plain fp32 reference (``reference/yolov8.py``), frame by frame
  (``compare.py``), each number beside its limit, with the frames compared;
* ``passes(checks)``: at least one frame compared, and no number over its
  limit;
* ``control(config)``: the control of the check, the program's own int8
  path (``precision: int8``).
"""

from __future__ import annotations

from typing import Dict, List


def checkpoint(ctx) -> str:
    from benchmark.weights import seeded_state_dict, write_checkpoint

    sd = seeded_state_dict(ctx.config["scale"], ctx.seed, ctx.device)
    ctx.state_dict = {k: v.cpu() for k, v in sd.items()}
    return write_checkpoint(ctx.state_dict, ctx.workdir, ctx.config["scale"], ctx.seed)


def detector_config(ctx, model_path: str, buckets, warmup: bool):
    from realtime_analytics_tpu_torch.config import DetectorConfig

    c = ctx.config
    return DetectorConfig(
        model_path=model_path, model_type="yolov8", device=ctx.device,
        confidence_threshold=c["confidence_threshold"], iou_threshold=c["iou_threshold"],
        input_size=[c["input_size"], c["input_size"]], num_classes=c["nc"],
        max_batch_size=max(buckets), batch_buckets=sorted(buckets),
        max_detections=c["max_detections"], pre_nms_topk=c["pre_nms_topk"],
        precision=c["precision"], warmup=warmup)


def check(config: Dict, state_dict, samples, device: str) -> Dict:
    """Each compared number's reading over the sampled frames, beside its
    limit. ``samples``: (key, frame uint8 [H, W, 3], boxes, scores, classes);
    the reference runs once over each distinct key, in blocks."""
    import numpy as np
    import torch

    from benchmark import compare
    from benchmark.reference.yolov8 import YoloV8, run as reference_run

    by_key: Dict = {}
    for s in samples:
        by_key.setdefault(s[0], []).append(s)
    keys = list(by_key)
    counts: List[Dict[str, int]] = []
    model = YoloV8(state_dict, device) if keys else None
    for lo in range(0, len(keys), 8):
        block = keys[lo:lo + 8]
        frames = torch.from_numpy(np.stack([by_key[k][0][1] for k in block]))
        anchors, dets = reference_run(
            model, frames, config["confidence_threshold"], config["iou_threshold"],
            config["pre_nms_topk"], config["max_detections"], config["input_size"])
        for k, a, d in zip(block, anchors, dets):
            for _, _, boxes, scores, classes in by_key[k]:
                counts.append(compare.frame_counts(a, d, boxes, scores, classes))
    readings = compare.shares(counts)
    out = {name: {"value": readings.get(name), "limit": limit}
           for name, limit in config["limits"].items()}
    out["frames"] = {"value": len(counts), "limit": 1}
    return out


def passes(checks: Dict) -> bool:
    ok = checks["frames"]["value"] >= checks["frames"]["limit"]
    return ok and all(c["value"] is None or c["value"] <= c["limit"]
                      for k, c in checks.items() if k != "frames")


def control(config: Dict) -> None:
    config["precision"] = "int8"
