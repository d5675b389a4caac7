"""realtime_analytics_tpu_torch — the PyTorch / CUDA port for one NVIDIA H100.

The same multi-stream realtime video analytics system as the JAX package
beside it (``realtime_analytics_tpu``, the reference), rebuilt on PyTorch:
32 concurrent video streams, YOLOv8 detection, ResNet classification and
four temporal action families behind a cross-stream batcher, IOU tracking
and Kafka/event-bus sinks. The package imports
nothing of JAX and nothing of the reference package; the host-side modules
it needs (config, types, tracker, ingest, sinks, metrics, the C pixel pick)
are its own copies.

Every kernel the reference wrote in Pallas for the TPU and that the serving
path reaches is a hand-written CUDA kernel for Hopper here (``csrc/``),
built with ``nvcc`` at first use and bound with ``ctypes``
(``ops/_cuda.py``). Each kernel keeps a plain PyTorch version beside it;
the plain version runs only for tensors on the CPU.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    ConfigError,
    DetectorConfig,
    FFmpegSimulatorConfig,
    KafkaSinkConfig,
    PipelineConfig,
    PrometheusConfig,
    StreamConfig,
    TrackerConfig,
    load_config,
)
from .types import Detection, FramePacket, TemporalDetection, Track  # noqa: F401
