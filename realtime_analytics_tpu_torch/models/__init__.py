"""Models as PyTorch modules (NCHW-logical, channels_last memory, OIHW
weights, BatchNorm folded at load):

  * ``yolo``     — YOLOv8 (anchor-free, DFL head) and YOLOv5 (anchors)
  * ``resnet``   — ResNet-18/34/50 classifiers
  * ``temporal`` — CNN-LSTM, ConvGRU, 3D-CNN and SlowFast clip models
  * ``weights``  — JAX params trees and torch state dicts -> modules
  * ``layers``   — conv / dense / SiLU / pool / upsample building blocks,
                   and the int8 form of the conv block
"""

from .resnet import ResNetModel, build_resnet  # noqa: F401
from .temporal import build_temporal  # noqa: F401
from .yolo import YoloModel, build_yolo  # noqa: F401
