"""Event consumer feeding the dashboard (reference api/kafka_consumer.py).

Transports mirror the sink side: aiokafka when available, the in-repo
eventbus, or tailing a JSONL file. Degrades gracefully (logs and idles) when
the requested transport is unavailable — the reference does the same when
aiokafka is missing (kafka_consumer.py:48-55).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Optional

from ..config import KafkaSinkConfig
from ..sinks.eventbus import EventBusSubscriber
from .schemas import parse_event
from .state import ConnectionManager, DashboardState

logger = logging.getLogger(__name__)

CONSUMER_GROUP = "realtime-analytics-dashboard"


class DetectionConsumer:
    def __init__(
        self,
        config: KafkaSinkConfig,
        state: DashboardState,
        manager: ConnectionManager,
    ):
        self.config = config
        self.state = state
        self.manager = manager
        self._task: Optional[asyncio.Task] = None
        self._stop = asyncio.Event()
        self.messages_consumed = 0

    async def start(self) -> None:
        if self._task is None:
            self._task = asyncio.create_task(self._run(), name="detection-consumer")

    async def stop(self) -> None:
        self._stop.set()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _run(self) -> None:
        transport = self.config.transport
        try:
            if transport == "kafka":
                await self._run_kafka()
            elif transport == "eventbus":
                await self._run_eventbus()
            elif transport == "jsonl":
                await self._run_jsonl()
            else:
                logger.warning("consumer transport '%s' idles", transport)
                await self._stop.wait()
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001
            logger.exception("detection consumer crashed")

    async def _handle(self, payload: dict) -> None:
        event = parse_event(payload)
        if event is None:
            logger.debug("dropping unparseable event")
            return
        self.messages_consumed += 1
        await self.state.update(event)
        await self.manager.broadcast_event(event)

    async def _run_kafka(self) -> None:
        try:
            from aiokafka import AIOKafkaConsumer  # type: ignore
        except ImportError:
            logger.warning("aiokafka missing — dashboard consumer idle")
            await self._stop.wait()
            return
        import json

        consumer = AIOKafkaConsumer(
            self.config.topic,
            bootstrap_servers=self.config.bootstrap_servers,
            group_id=CONSUMER_GROUP,
            value_deserializer=lambda b: json.loads(b.decode("utf-8")),
        )
        await consumer.start()
        try:
            while not self._stop.is_set():
                try:
                    msg = await asyncio.wait_for(consumer.getone(), timeout=0.5)
                except asyncio.TimeoutError:
                    continue
                await self._handle(msg.value)
        finally:
            await consumer.stop()

    async def _run_eventbus(self) -> None:
        host, _, port = self.config.bootstrap_servers.partition(":")
        while not self._stop.is_set():
            sub = EventBusSubscriber(
                host or "127.0.0.1", int(port or 9192), self.config.topic
            )
            try:
                await sub.connect()
                logger.info("dashboard consuming eventbus topic '%s'", self.config.topic)
                async for payload in sub.messages():
                    if payload is not None:
                        await self._handle(payload)
                    if self._stop.is_set():
                        break
            except (ConnectionRefusedError, OSError) as exc:
                logger.warning("eventbus unavailable (%s); retrying in 2s", exc)
                await asyncio.sleep(2.0)
            finally:
                await sub.close()

    async def _run_jsonl(self) -> None:
        import json
        from pathlib import Path

        path = Path(self.config.jsonl_path or "analytics_events.jsonl")
        pos = 0
        while not self._stop.is_set():
            if path.exists():
                # binary + manual splitting: a line still being written by
                # the sink (multi-MB frame_jpeg events flush mid-line) must
                # NOT advance pos past the fragment, or both halves fail
                # JSON parse and the event is lost; only complete
                # newline-terminated lines are consumed
                with path.open("rb") as f:
                    f.seek(pos)
                    chunk = f.read()
                complete, sep, _partial = chunk.rpartition(b"\n")
                if sep:
                    pos += len(complete) + 1
                    for raw in complete.split(b"\n"):
                        line = raw.strip()
                        if line:
                            try:
                                await self._handle(
                                    json.loads(line.decode("utf-8"))
                                )
                            except (json.JSONDecodeError, UnicodeDecodeError):
                                pass
            await asyncio.sleep(0.25)
