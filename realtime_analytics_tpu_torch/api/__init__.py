"""Dashboard API: event consumer + HTTP/WebSocket server + static frontend.

Separate process from the pipeline, connected only through the event bus
(Kafka or the in-repo eventbus) — the reference's process topology
(reference api/, docker-compose-full.yaml).
"""

from .schemas import DashboardSnapshot, DetectionEvent, TrackPayload, WsEnvelope  # noqa: F401
from .state import ConnectionManager, DashboardState  # noqa: F401
from .server import DashboardServer  # noqa: F401
