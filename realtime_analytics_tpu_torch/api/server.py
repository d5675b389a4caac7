"""Dashboard HTTP + WebSocket server.

Route parity with the reference FastAPI app (api/server.py:51-191):
  GET /                      -> static/index.html
  GET /static/<asset>        -> bundled frontend assets
  GET /favicon.ico           -> 1x1 png
  GET /api/snapshot          -> latest event per stream (JSON)
  GET /api/export/json       -> snapshot export (?streams=a,b filter)
  GET /api/export/csv        -> CSV export incl. temporal columns
  WS  /ws                    -> snapshot envelope on connect, then live
                                {"type": "event", ...} pushes

Implementation: one ``websockets`` server handles both protocols —
``process_request`` answers plain HTTP, WebSocket upgrades fall through to
the connection handler. No FastAPI/uvicorn dependency (not in this image);
capability and wire format are identical.
"""

from __future__ import annotations

import asyncio
import base64
import csv
import io
import json
import logging
from http import HTTPStatus
from pathlib import Path
from typing import Optional
from urllib.parse import parse_qs, urlparse

from websockets.asyncio.server import serve
from websockets.datastructures import Headers
from websockets.http11 import Response

from ..config import KafkaSinkConfig
from .consumer import DetectionConsumer
from .schemas import WsEnvelope
from .state import ConnectionManager, DashboardState

logger = logging.getLogger(__name__)

STATIC_DIR = Path(__file__).parent / "static"

_FAVICON = base64.b64decode(
    "iVBORw0KGgoAAAANSUhEUgAAAAEAAAABCAYAAAAfFcSJAAAADUlEQVR42mNk+M9QDwADhgGAWjR9awAAAABJRU5ErkJggg=="
)

_CONTENT_TYPES = {
    ".html": "text/html; charset=utf-8",
    ".js": "application/javascript; charset=utf-8",
    ".css": "text/css; charset=utf-8",
    ".png": "image/png",
    ".svg": "image/svg+xml",
    ".json": "application/json",
}

CSV_COLUMNS = [
    "stream", "frame_id", "received_at", "track_id", "class_id", "confidence",
    "x1", "y1", "x2", "y2", "action_label", "temporal_score",
    "sequence_start_frame", "sequence_end_frame",
]


def _response(status: HTTPStatus, body: bytes, content_type: str) -> Response:
    headers = Headers(
        [
            ("Content-Type", content_type),
            ("Content-Length", str(len(body))),
            ("Cache-Control", "no-cache"),
            ("Access-Control-Allow-Origin", "*"),
        ]
    )
    return Response(status.value, status.phrase, headers, body)


def _json_response(obj, status: HTTPStatus = HTTPStatus.OK) -> Response:
    return _response(
        status, json.dumps(obj).encode("utf-8"), "application/json; charset=utf-8"
    )


class DashboardServer:
    def __init__(
        self,
        kafka_config: KafkaSinkConfig,
        host: str = "0.0.0.0",
        port: int = 8080,
        static_dir: Optional[Path] = None,
    ):
        self.host = host
        self.port = port
        self.static_dir = static_dir or STATIC_DIR
        self.state = DashboardState()
        self.manager = ConnectionManager()
        self.consumer = DetectionConsumer(kafka_config, self.state, self.manager)
        self._server = None

    # -- lifecycle -----------------------------------------------------------

    async def start(self) -> None:
        await self.consumer.start()
        self._server = await serve(
            self._ws_handler,
            self.host,
            self.port,
            process_request=self._process_request,
            max_size=64 * 1024 * 1024,
        )
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("Dashboard on http://%s:%d/ (ws: /ws)", self.host, self.port)

    async def stop(self) -> None:
        await self.consumer.stop()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def serve_forever(self) -> None:
        await self.start()
        try:
            await asyncio.get_running_loop().create_future()  # until cancelled
        finally:
            await self.stop()

    # -- HTTP ----------------------------------------------------------------

    async def _process_request(self, connection, request) -> Optional[Response]:
        parsed = urlparse(request.path)
        path = parsed.path
        if path == "/ws":
            return None  # continue with the WebSocket handshake
        try:
            return await self._route(path, parse_qs(parsed.query))
        except Exception:  # noqa: BLE001
            logger.exception("error serving %s", path)
            return _json_response(
                {"error": "internal error"}, HTTPStatus.INTERNAL_SERVER_ERROR
            )

    async def _route(self, path: str, query) -> Response:
        if path == "/":
            return self._static("index.html")
        if path == "/wall":
            return self._static("wall.html")
        if path == "/showcase":
            # static showcase pages (≙ reference modern-dashboard.html /
            # enterprise-dashboard.html): self-animating synthetic views,
            # no backend dependency
            return self._static("showcase.html")
        if path == "/command":
            return self._static("command.html")
        if path.startswith("/static/"):
            return self._static(path[len("/static/"):])
        if path == "/favicon.ico":
            return _response(HTTPStatus.OK, _FAVICON, "image/png")
        if path == "/api/snapshot":
            snap = await self.state.snapshot()
            return _response(
                HTTPStatus.OK, snap.model_dump_json().encode(), "application/json"
            )
        if path == "/api/export/json":
            events = await self._filtered_events(query)
            body = json.dumps(
                [json.loads(e.model_dump_json()) for e in events]
            ).encode()
            return _response(HTTPStatus.OK, body, "application/json")
        if path == "/api/export/csv":
            events = await self._filtered_events(query)
            return _response(
                HTTPStatus.OK, self._to_csv(events), "text/csv; charset=utf-8"
            )
        if path == "/api/health":
            return _json_response(
                {
                    "status": "ok",
                    "ws_clients": self.manager.count,
                    "messages_consumed": self.consumer.messages_consumed,
                }
            )
        return _json_response({"error": "not found"}, HTTPStatus.NOT_FOUND)

    async def _filtered_events(self, query):
        snap = await self.state.snapshot()
        events = snap.events
        wanted = query.get("streams", [])
        if wanted:
            names = {s for part in wanted for s in part.split(",") if s}
            events = [e for e in events if e.stream in names]
        return events

    @staticmethod
    def _to_csv(events) -> bytes:
        buf = io.StringIO()
        writer = csv.writer(buf)
        writer.writerow(CSV_COLUMNS)
        for e in events:
            for t in e.tracks:
                x1, y1, x2, y2 = (t.bbox_xyxy + [0, 0, 0, 0])[:4]
                writer.writerow(
                    [
                        e.stream, e.frame_id, e.received_at.isoformat(),
                        t.track_id, t.class_id, t.confidence,
                        x1, y1, x2, y2,
                        t.action_label or "",
                        # `or ""` would drop legitimate zeros (score 0.0,
                        # sequences starting at frame 0)
                        "" if t.temporal_score is None else t.temporal_score,
                        "" if t.sequence_start_frame is None
                        else t.sequence_start_frame,
                        "" if t.sequence_end_frame is None
                        else t.sequence_end_frame,
                    ]
                )
        return buf.getvalue().encode("utf-8")

    def _static(self, rel: str) -> Response:
        target = (self.static_dir / rel).resolve()
        # is_relative_to, not str.startswith: a prefix check would also
        # accept sibling dirs sharing the name prefix (static_private/)
        if not target.is_relative_to(self.static_dir.resolve()) or (
            not target.is_file()
        ):
            return _json_response({"error": "not found"}, HTTPStatus.NOT_FOUND)
        ctype = _CONTENT_TYPES.get(target.suffix, "application/octet-stream")
        return _response(HTTPStatus.OK, target.read_bytes(), ctype)

    # -- WebSocket -----------------------------------------------------------

    async def _ws_handler(self, websocket) -> None:
        await self.manager.register(websocket)
        try:
            snap = await self.state.snapshot()
            envelope = WsEnvelope(
                type="snapshot", payload=json.loads(snap.model_dump_json())
            )
            await websocket.send(envelope.model_dump_json())
            # hold the connection, reading (and ignoring) client text
            async for _ in websocket:
                pass
        except Exception:  # noqa: BLE001 — disconnects are routine
            pass
        finally:
            await self.manager.unregister(websocket)
