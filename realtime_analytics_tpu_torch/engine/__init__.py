"""The PyTorch inference engine.

  * ``detector`` — the YOLO detection and ResNet classification engines
    and the ``create_detector`` factory (reference-compatible routing)
  * ``temporal`` — the clip engine of the four temporal families
  * ``batcher``  — the cross-stream dynamic batcher (asyncio)
  * ``graphs``   — the YOLO engines' step cache: one step per bucket,
    captured as a CUDA graph on the card
"""

from .detector import (  # noqa: F401
    BaseDetector,
    TorchResNetEngine,
    TorchYoloEngine,
    create_detector,
)
from .temporal import TorchTemporalEngine  # noqa: F401
from .batcher import InferenceBatcher  # noqa: F401
