"""The PyTorch inference engine.

  * ``detector`` — the YOLO detection engine and the ``create_detector``
    factory (reference-compatible routing; routes not ported yet raise
    NotImplementedError naming ROADMAP.md)
  * ``batcher``  — the cross-stream dynamic batcher (asyncio)
"""

from .detector import BaseDetector, TorchYoloEngine, create_detector  # noqa: F401
from .batcher import InferenceBatcher  # noqa: F401
