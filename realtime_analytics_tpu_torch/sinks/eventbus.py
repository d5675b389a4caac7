"""Minimal asyncio pub/sub event bus (newline-delimited JSON over TCP).

A dependency-free stand-in for the Kafka broker in the reference's process
topology (pipeline proc -> broker -> dashboard proc,
docker-compose-full.yaml:4-29). Same decoupling role, same JSON payloads —
usable whenever a real Kafka/aiokafka is unavailable, and handy for tests.

Protocol: one JSON object per line.
  client -> broker: {"op": "sub", "topic": T} | {"op": "pub", "topic": T,
                     "payload": {...}}
  broker -> subscriber: {"topic": T, "payload": {...}}
"""

from __future__ import annotations

import asyncio
import json
import logging
from collections import defaultdict
from typing import AsyncIterator, Dict, Optional, Set

logger = logging.getLogger(__name__)

_MAX_LINE = 64 * 1024 * 1024  # frame previews can be large


class EventBusBroker:
    """Topic-based fan-out broker."""

    def __init__(self, host: str = "127.0.0.1", port: int = 9192):
        self.host = host
        self.port = port
        self._server: Optional[asyncio.AbstractServer] = None
        self._subscribers: Dict[str, Set[asyncio.StreamWriter]] = defaultdict(set)
        self._connections: Set[asyncio.StreamWriter] = set()
        self.messages_routed = 0

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port, limit=_MAX_LINE
        )
        addr = self._server.sockets[0].getsockname()
        self.port = addr[1]  # resolve port 0 -> real port
        logger.info("EventBus broker listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Close every live connection BEFORE wait_closed(): since
            # py3.12 wait_closed() waits for handler coroutines too, and a
            # connected client parked in readline() would otherwise block
            # broker (and pipeline SIGTERM) shutdown until the CLIENT went
            # away. Closing the transport EOFs the reader and the handler
            # winds down on its own.
            for w in list(self._connections):
                w.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=3)
            except asyncio.TimeoutError:
                logger.warning(
                    "EventBus broker: connection handlers did not wind "
                    "down within 3 s; abandoning them"
                )
            self._server = None
        self._subscribers.clear()
        self._connections.clear()

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        subscribed: Set[str] = set()
        self._connections.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("EventBus: dropping malformed line")
                    continue
                op = msg.get("op")
                topic = msg.get("topic", "")
                if op == "sub":
                    subscribed.add(topic)
                    self._subscribers[topic].add(writer)
                elif op == "pub":
                    await self._fanout(topic, msg.get("payload"))
        except (OSError, asyncio.IncompleteReadError):
            # OSError covers BrokenPipeError/ConnectionResetError — a
            # subscriber dropping mid-fanout surfaces the transport error
            # through the reader waiter too (seen as an unhandled
            # client_connected_cb exception under load)
            pass
        finally:
            for topic in subscribed:
                self._subscribers[topic].discard(writer)
            self._connections.discard(writer)
            writer.close()

    #: seconds a subscriber may stall its socket before being dropped —
    #: _fanout runs inside the PUBLISHER's handler coroutine, so one
    #: laggard blocking drain() forever would halt the whole bus
    DRAIN_TIMEOUT_S = 5.0

    async def _fanout(self, topic: str, payload) -> None:
        data = (json.dumps({"topic": topic, "payload": payload}) + "\n").encode()
        dead = []
        # snapshot: subscribers may connect/drop while we await drain()
        for w in list(self._subscribers.get(topic, ())):
            try:
                w.write(data)
                await asyncio.wait_for(w.drain(), timeout=self.DRAIN_TIMEOUT_S)
                self.messages_routed += 1
            except asyncio.TimeoutError:
                logger.warning(
                    "EventBus: subscriber stalled > %.0fs on topic '%s'; "
                    "dropping it", self.DRAIN_TIMEOUT_S, topic,
                )
                w.close()
                dead.append(w)
            except (OSError, RuntimeError):
                dead.append(w)
        for w in dead:
            self._subscribers[topic].discard(w)


class EventBusPublisher:
    def __init__(self, host: str, port: int):
        self.host = host
        self.port = port
        self._writer: Optional[asyncio.StreamWriter] = None
        self._lock = asyncio.Lock()

    async def connect(self) -> None:
        _, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=_MAX_LINE
        )

    async def publish(self, topic: str, payload: dict) -> None:
        if self._writer is None:
            raise RuntimeError("publisher not connected")
        line = (json.dumps({"op": "pub", "topic": topic, "payload": payload}) + "\n")
        async with self._lock:
            self._writer.write(line.encode())
            await self._writer.drain()

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


class EventBusSubscriber:
    def __init__(self, host: str, port: int, topic: str):
        self.host = host
        self.port = port
        self.topic = topic
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=_MAX_LINE
        )
        sub = json.dumps({"op": "sub", "topic": self.topic}) + "\n"
        self._writer.write(sub.encode())
        await self._writer.drain()

    async def messages(self) -> AsyncIterator[dict]:
        if self._reader is None:
            raise RuntimeError("subscriber not connected")
        while True:
            line = await self._reader.readline()
            if not line:
                return
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                continue
            yield msg.get("payload")

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None
