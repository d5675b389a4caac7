"""Dashboard state + WebSocket fan-out (reference api/state.py:20-78)."""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Dict, List, Set

from .schemas import DashboardSnapshot, DetectionEvent, WsEnvelope

logger = logging.getLogger(__name__)


class DashboardState:
    """Latest event per stream, under a lock."""

    def __init__(self) -> None:
        self._events: Dict[str, DetectionEvent] = {}
        self._lock = asyncio.Lock()

    async def update(self, event: DetectionEvent) -> None:
        async with self._lock:
            self._events[event.stream] = event

    async def snapshot(self) -> DashboardSnapshot:
        async with self._lock:
            events = sorted(
                self._events.values(), key=lambda e: e.received_at, reverse=True
            )
        return DashboardSnapshot(events=list(events))


class ConnectionManager:
    """Set of live WebSocket connections with broadcast + dead cleanup."""

    def __init__(self) -> None:
        self._connections: Set = set()
        self._lock = asyncio.Lock()

    async def register(self, ws) -> None:
        async with self._lock:
            self._connections.add(ws)

    async def unregister(self, ws) -> None:
        async with self._lock:
            self._connections.discard(ws)

    async def broadcast_event(self, event: DetectionEvent) -> None:
        envelope = WsEnvelope(
            type="event", payload=json.loads(event.model_dump_json())
        )
        await self._broadcast(envelope.model_dump_json())

    async def _broadcast(self, text: str) -> None:
        async with self._lock:
            targets = list(self._connections)
        dead: List = []
        for ws in targets:
            try:
                await ws.send(text)
            except Exception:  # noqa: BLE001 — any send failure drops the conn
                dead.append(ws)
        if dead:
            async with self._lock:
                for ws in dead:
                    self._connections.discard(ws)

    @property
    def count(self) -> int:
        return len(self._connections)
