"""Detection-accuracy evaluation (mAP) — beyond-reference capability.

The reference ships no accuracy tooling at all (users fall back to
Ultralytics ``val``, which needs the torch stack). This package provides a
dependency-free COCO-style evaluator so checkpoint fidelity and int8/bf16
precision choices can be validated with numbers on any backend.
"""

from .detection_metrics import (  # noqa: F401
    DetectionSample,
    average_precision,
    evaluate_detections,
    match_detections,
)
