"""Host-side ingest: video capture, RTSP simulation, synthetic sources.

Capture and decode stay on the host CPU (OpenCV/FFmpeg), exactly as the
reference keeps them on the CPU (video_stream.py) — the card sees only packed
uint8 frame batches.
"""

from .video_stream import StreamSourceError, VideoStream  # noqa: F401
from .synthetic import SyntheticSource  # noqa: F401
from .ffmpeg_simulator import FFmpegStreamError, FFmpegStreamSimulator  # noqa: F401
