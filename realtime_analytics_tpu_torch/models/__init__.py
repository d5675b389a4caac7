"""Models as PyTorch modules (NCHW-logical, channels_last memory, OIHW
weights, BatchNorm folded at load):

  * ``yolo``    — YOLOv8 (anchor-free, DFL head); YOLOv5 is not ported yet
  * ``weights`` — JAX params trees and Ultralytics state dicts -> modules
  * ``layers``  — conv / SiLU / pool / upsample building blocks
"""

from .yolo import YoloModel, build_yolo  # noqa: F401
