"""The port's dashboard (``realtime_analytics_tpu_torch.api``): every case of
tests/test_dashboard.py run on the port's copy, the aiokafka path end to
end, and one case across the two packages.

Dashboard integration: pipeline sink -> eventbus broker -> dashboard
consumer -> HTTP snapshot/export + WebSocket push (3-process topology of the
reference, docker-compose-full.yaml, collapsed into one test loop)."""

import asyncio
import json
import urllib.request

import pytest
import websockets

from realtime_analytics_tpu_torch.api.server import DashboardServer
from realtime_analytics_tpu_torch.config import KafkaSinkConfig
from realtime_analytics_tpu_torch.sinks.eventbus import EventBusBroker
from realtime_analytics_tpu_torch.sinks.kafka_sink import KafkaSink
from realtime_analytics_tpu_torch.types import Track


def _track(i=1, temporal=False):
    kw = {}
    if temporal:
        kw = dict(action_label="running", temporal_score=0.9,
                  sequence_start_frame=1, sequence_end_frame=8)
    return Track(track_id=i, stream_name="cam", class_id=2, confidence=0.88,
                 bbox_xyxy=(10.0, 20.0, 110.0, 220.0), age=0, hits=3, **kw)


async def _http_get(url):
    return await asyncio.to_thread(
        lambda: urllib.request.urlopen(url, timeout=5).read().decode()
    )


@pytest.fixture()
def bus_config():
    return KafkaSinkConfig(
        enabled=True, transport="eventbus", bootstrap_servers="127.0.0.1:0",
        topic="analytics.events",
    )


def test_eventbus_end_to_end(bus_config):
    async def scenario():
        broker = EventBusBroker("127.0.0.1", 0)
        await broker.start()
        bus_config.bootstrap_servers = f"127.0.0.1:{broker.port}"

        server = DashboardServer(bus_config, host="127.0.0.1", port=0)
        await server.start()
        await asyncio.sleep(0.2)  # consumer subscribes

        sink = KafkaSink(bus_config)
        await sink.connect()

        # WS client connects before events flow: gets snapshot then events
        ws_url = f"ws://127.0.0.1:{server.port}/ws"
        received = []
        async with websockets.connect(ws_url) as ws:
            first = json.loads(await ws.recv())
            assert first["type"] == "snapshot"

            await sink.send_tracks("cam", 7, [_track(1), _track(2, temporal=True)])
            msg = json.loads(await asyncio.wait_for(ws.recv(), timeout=5))
            received.append(msg)

        assert received[0]["type"] == "event"
        payload = received[0]["payload"]
        assert payload["stream"] == "cam"
        assert payload["frame_id"] == 7
        assert payload["is_temporal"] is True
        temporal_track = payload["tracks"][1]
        assert temporal_track["action_label"] == "running"  # fields round-trip

        # HTTP snapshot
        snap = json.loads(
            await _http_get(f"http://127.0.0.1:{server.port}/api/snapshot")
        )
        assert snap["events"][0]["stream"] == "cam"
        assert len(snap["events"][0]["tracks"]) == 2

        # exports
        exported = json.loads(
            await _http_get(
                f"http://127.0.0.1:{server.port}/api/export/json?streams=cam"
            )
        )
        assert len(exported) == 1
        csv_text = await _http_get(
            f"http://127.0.0.1:{server.port}/api/export/csv"
        )
        lines = csv_text.strip().splitlines()
        assert lines[0].startswith("stream,frame_id")
        assert len(lines) == 3  # header + 2 tracks
        assert "running" in csv_text

        # filtered-out stream yields empty export
        empty = json.loads(
            await _http_get(
                f"http://127.0.0.1:{server.port}/api/export/json?streams=nope"
            )
        )
        assert empty == []

        # static frontend served
        html = await _http_get(f"http://127.0.0.1:{server.port}/")
        assert "Realtime Analytics" in html
        js = await _http_get(f"http://127.0.0.1:{server.port}/static/main.js")
        assert "snapshot" in js

        # health endpoint
        health = json.loads(
            await _http_get(f"http://127.0.0.1:{server.port}/api/health")
        )
        assert health["status"] == "ok"
        assert health["messages_consumed"] >= 1

        await sink.close()
        await server.stop()
        await broker.stop()

    asyncio.run(scenario())


def test_broker_stop_with_connected_subscriber_is_prompt(bus_config):
    """Regression: SIGTERM'ing the pipeline while a dashboard consumer is
    still attached must not hang. Since py3.12 Server.wait_closed() waits
    for handler coroutines, and an idle subscriber parked in readline()
    kept the broker (and the whole run_pipeline process) alive until the
    CLIENT disconnected — observed as a pipeline that logged "Pipeline
    stopped" but never exited."""

    async def scenario():
        broker = EventBusBroker("127.0.0.1", 0)
        await broker.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", broker.port)
        writer.write(b'{"op": "sub", "topic": "analytics.events"}\n')
        await writer.drain()
        await asyncio.sleep(0.1)  # handler registers the subscription
        # the client stays connected and silent; stop() must still return
        await asyncio.wait_for(broker.stop(), timeout=2.0)
        # client observes EOF (broker closed the transport)
        assert await asyncio.wait_for(reader.read(), 2.0) == b""
        writer.close()

    asyncio.run(scenario())


def test_jsonl_sink_and_consumer(tmp_path):
    async def scenario():
        path = tmp_path / "events.jsonl"
        cfg = KafkaSinkConfig(
            enabled=True, transport="jsonl", jsonl_path=str(path), topic="t"
        )
        sink = KafkaSink(cfg)
        await sink.connect()
        await sink.send_tracks("cam-a", 1, [_track()])
        await sink.send_tracks("cam-b", 2, [])
        await sink.close()

        lines = path.read_text().strip().splitlines()
        assert len(lines) == 2
        assert json.loads(lines[0])["stream"] == "cam-a"

        server = DashboardServer(cfg, host="127.0.0.1", port=0)
        await server.start()
        await asyncio.sleep(0.8)  # jsonl tail poll
        snap = await server.state.snapshot()
        assert {e.stream for e in snap.events} == {"cam-a", "cam-b"}
        await server.stop()

    asyncio.run(scenario())


def test_jsonl_consumer_waits_for_complete_lines(tmp_path):
    # a line still being written (sink flushes mid-line on multi-MB
    # frame_jpeg payloads) must NOT be consumed-and-lost: the tail only
    # advances past newline-terminated lines
    async def scenario():
        path = tmp_path / "events.jsonl"
        cfg = KafkaSinkConfig(
            enabled=True, transport="jsonl", jsonl_path=str(path), topic="t"
        )
        full = json.dumps({"stream": "cam-a", "frame_id": 1, "tracks": []})
        partial = json.dumps(
            {"stream": "cam-b", "frame_id": 2, "tracks": []}
        )
        with path.open("w") as f:
            f.write(full + "\n")
            f.write(partial[: len(partial) // 2])  # fragment, no newline
            f.flush()

        server = DashboardServer(cfg, host="127.0.0.1", port=0)
        await server.start()
        await asyncio.sleep(0.8)
        snap = await server.state.snapshot()
        assert {e.stream for e in snap.events} == {"cam-a"}  # fragment held

        with path.open("a") as f:  # writer completes the line
            f.write(partial[len(partial) // 2:] + "\n")
        await asyncio.sleep(0.8)
        snap = await server.state.snapshot()
        assert {e.stream for e in snap.events} == {"cam-a", "cam-b"}
        await server.stop()

    asyncio.run(scenario())


def test_eventbus_publisher_reconnects_after_broker_restart():
    # producer-side reconnect (the consumer side always had one): a broker
    # restart must not mean silent event loss for the process lifetime
    async def scenario():
        from realtime_analytics_tpu_torch.sinks.eventbus import (
            EventBusBroker,
            EventBusSubscriber,
        )

        broker = EventBusBroker(host="127.0.0.1", port=0)
        await broker.start()
        port = broker.port
        cfg = KafkaSinkConfig(
            enabled=True, transport="eventbus",
            bootstrap_servers=f"127.0.0.1:{port}", topic="t",
        )
        sink = KafkaSink(cfg)
        await sink.connect()
        await sink.send_tracks("cam-a", 1, [_track()])

        await broker.stop()  # broker restarts on the same port
        broker2 = EventBusBroker(host="127.0.0.1", port=port)
        await broker2.start()
        sub = EventBusSubscriber("127.0.0.1", port, "t")
        await sub.connect()

        # first send may fail AND reconnect in one call; at most one
        # retry-send is needed before events flow again
        for frame_id in (2, 3):
            try:
                await sink.send_tracks("cam-a", frame_id, [_track()])
            except Exception:  # noqa: BLE001 — dead socket detection race
                pass
        got = await asyncio.wait_for(sub.messages().__anext__(), 3.0)
        assert got["stream"] == "cam-a"
        await sub.close()
        await sink.close()
        await broker2.stop()

    asyncio.run(scenario())


def test_eventbus_reconnect_cooldown_degrades_to_fast_drops():
    # advisor r3: with a black-holed/dead broker, every send must NOT
    # serialize behind a full TCP connect while _publish holds the lock —
    # after one failed reconnect, sends inside the cooldown drop fast
    # without another connect attempt; after the cooldown a reconnect is
    # tried again (and succeeds once the broker is back)
    async def scenario():
        from realtime_analytics_tpu_torch.sinks.eventbus import (
            EventBusBroker,
            EventBusSubscriber,
        )

        broker = EventBusBroker(host="127.0.0.1", port=0)
        await broker.start()
        port = broker.port
        cfg = KafkaSinkConfig(
            enabled=True, transport="eventbus",
            bootstrap_servers=f"127.0.0.1:{port}", topic="t",
        )
        sink = KafkaSink(cfg)
        await sink.connect()
        await sink.send_tracks("cam-a", 1, [_track()])
        await broker.stop()  # broker gone for good (for now)

        connects = 0
        real_connect = sink._bus.connect

        async def counting_connect():
            nonlocal connects
            connects += 1
            await real_connect()

        sink._bus.connect = counting_connect
        sink._bus_reconnect_cooldown_s = 30.0
        for frame_id in (2, 3, 4):
            try:
                await sink.send_tracks("cam-a", frame_id, [_track()])
            except Exception:  # noqa: BLE001 — expected: broker is down
                pass
        # first failing send may need up to two connects (dead-socket
        # detection -> reconnect); the cooldown must stop the later sends
        # from adding more
        assert connects <= 2
        assert sink._bus_reconnect_failed_at is not None

        # cooldown expiry: reconnect is attempted again and succeeds
        broker2 = EventBusBroker(host="127.0.0.1", port=port)
        await broker2.start()
        sub = EventBusSubscriber("127.0.0.1", port, "t")
        await sub.connect()
        sink._bus_reconnect_cooldown_s = 0.0
        for frame_id in (5, 6):
            try:
                await sink.send_tracks("cam-a", frame_id, [_track()])
            except Exception:  # noqa: BLE001
                pass
        got = await asyncio.wait_for(sub.messages().__anext__(), 3.0)
        assert got["stream"] == "cam-a"
        assert sink._bus_reconnect_failed_at is None
        await sub.close()
        await sink.close()
        await broker2.stop()

    asyncio.run(scenario())


def test_dead_bus_drops_are_absorbed_not_raised():
    # review r4: a dead bus must not turn served frames into completion
    # failures — send_tracks absorbs the drop (counts + rate-limited log)
    # instead of raising per frame into the completion loop
    async def scenario():
        broker = EventBusBroker(host="127.0.0.1", port=0)
        await broker.start()
        cfg = KafkaSinkConfig(
            enabled=True, transport="eventbus",
            bootstrap_servers=f"127.0.0.1:{broker.port}", topic="t",
        )
        sink = KafkaSink(cfg)
        await sink.connect()
        await sink.send_tracks("cam-a", 1, [_track()])
        await broker.stop()
        # all sends after the broker dies return cleanly — no exception
        # during the failed-reconnect send NOR during the cooldown window
        for frame_id in (2, 3, 4, 5):
            await sink.send_tracks("cam-a", frame_id, [_track()])
        assert sink.messages_dropped >= 4
        assert sink._bus_reconnect_failed_at is not None
        await sink.close()

    asyncio.run(scenario())


def test_sink_frame_rate_limit():
    async def scenario():
        cfg = KafkaSinkConfig(
            enabled=True, transport="memory", include_frames=True,
            frame_interval_seconds=10.0,
        )
        sink = KafkaSink(cfg)
        await sink.connect()
        import numpy as np

        frame = np.zeros((60, 80, 3), dtype=np.uint8)
        await sink.send_tracks("cam", 1, [_track()], frame)
        await sink.send_tracks("cam", 2, [_track()], frame)  # rate-limited
        assert "frame_jpeg" in sink.memory_buffer[0]
        assert "frame_jpeg" not in sink.memory_buffer[1]
        assert sink.memory_buffer[0]["frame_jpeg"].startswith("data:image/")
        await sink.close()

    asyncio.run(scenario())


def test_adaptive_quality_bounds():
    cfg = KafkaSinkConfig(enabled=True, frame_quality=75)
    sink = KafkaSink(cfg)
    assert sink._calculate_adaptive_quality(0) == 65
    assert sink._calculate_adaptive_quality(2) == 75
    assert sink._calculate_adaptive_quality(7) == 80
    assert sink._calculate_adaptive_quality(30) == 85
    hi = KafkaSink(KafkaSinkConfig(enabled=True, frame_quality=95))
    assert hi._calculate_adaptive_quality(30) == 95  # clamped
    lo = KafkaSink(KafkaSinkConfig(enabled=True, frame_quality=50))
    assert lo._calculate_adaptive_quality(0) == 50  # clamped


def test_kafka_end_to_end_sink_to_dashboard(monkeypatch):
    """The port's copy of tests/test_kafka_transport.py's end-to-end case:
    producer -> wire bytes -> consumer.getone -> parse_event -> dashboard
    state, with aiokafka replaced by the same protocol-level fake."""
    from realtime_analytics_tpu_torch.api.consumer import DetectionConsumer
    from realtime_analytics_tpu_torch.api.state import (
        ConnectionManager,
        DashboardState,
    )
    from test_kafka_transport import FakeBroker, install_fake_aiokafka

    broker = FakeBroker()
    install_fake_aiokafka(monkeypatch, broker)
    cfg = KafkaSinkConfig(enabled=True, transport="kafka",
                          bootstrap_servers="fake:9092", topic="analytics.events")

    async def run():
        sink = KafkaSink(cfg)
        await sink.connect()
        state = DashboardState()
        consumer = DetectionConsumer(cfg, state, ConnectionManager())
        await consumer.start()
        await sink.send_tracks("cam-1", 3, [_track(5)])
        await sink.send_tracks("cam-2", 4, [_track(6)])
        for _ in range(100):
            if consumer.messages_consumed >= 2:
                break
            await asyncio.sleep(0.02)
        snap = await state.snapshot()
        await consumer.stop()
        await sink.close()
        return consumer.messages_consumed, snap

    consumed, snap = asyncio.run(run())
    assert consumed == 2
    by_stream = {e.stream: e for e in snap.events}
    assert set(by_stream) == {"cam-1", "cam-2"}
    assert by_stream["cam-1"].tracks[0].track_id == 5
    assert by_stream["cam-2"].tracks[0].track_id == 6


def _without_clocks(snapshot: dict) -> list:
    """A snapshot's events by stream, without the times each server stamps
    on arrival."""
    events = [{k: v for k, v in e.items() if k != "received_at"}
              for e in snapshot["events"]]
    return sorted(events, key=lambda e: e["stream"])


@pytest.mark.parametrize("producer", ["jax", "torch"])
def test_either_package_feeds_the_other_dashboard(producer):
    """One event bus, a pipeline sink of one package, a dashboard of each:
    the other package's dashboard pushes every event over /ws and ends with
    the same snapshot as the producer's own (the Kafka payload is one
    contract, sinks/kafka_sink.py)."""
    import realtime_analytics_tpu.api.server as jax_server
    import realtime_analytics_tpu.sinks.kafka_sink as jax_sink
    import realtime_analytics_tpu.types as jax_types

    server_of = {"jax": jax_server.DashboardServer, "torch": DashboardServer}
    own = server_of[producer]
    other = server_of["torch" if producer == "jax" else "jax"]
    sink_cls, track_cls = {"jax": (jax_sink.KafkaSink, jax_types.Track),
                           "torch": (KafkaSink, Track)}[producer]

    def track(i, temporal=False):
        kw = dict(action_label="running", temporal_score=0.9,
                  sequence_start_frame=1, sequence_end_frame=8) if temporal else {}
        return track_cls(track_id=i, stream_name="cam", class_id=2,
                         confidence=0.88, bbox_xyxy=(10.0, 20.0, 110.0, 220.0),
                         age=0, hits=3, **kw)

    sent = [("cam-a", 1, [track(1)]), ("cam-b", 2, [track(2), track(3, True)]),
            ("cam-a", 3, []), ("cam-c", 4, [track(4, True)])]

    async def scenario():
        broker = EventBusBroker("127.0.0.1", 0)
        await broker.start()
        cfg = KafkaSinkConfig(enabled=True, transport="eventbus",
                              bootstrap_servers=f"127.0.0.1:{broker.port}",
                              topic="analytics.events")
        servers = [own(cfg, host="127.0.0.1", port=0),
                   other(cfg, host="127.0.0.1", port=0)]
        for server in servers:
            await server.start()
        await asyncio.sleep(0.3)  # both consumers subscribe
        sink = sink_cls(cfg)
        await sink.connect()
        pushed = []
        async with websockets.connect(f"ws://127.0.0.1:{servers[1].port}/ws") as ws:
            first = json.loads(await asyncio.wait_for(ws.recv(), timeout=5))
            for stream, frame_id, tracks in sent:
                await sink.send_tracks(stream, frame_id, tracks)
            while len(pushed) < len(sent):
                pushed.append(json.loads(await asyncio.wait_for(ws.recv(), timeout=5)))
        for server in servers:
            for _ in range(100):
                if server.consumer.messages_consumed >= len(sent):
                    break
                await asyncio.sleep(0.02)
        snaps = [json.loads(await _http_get(f"http://127.0.0.1:{s.port}/api/snapshot"))
                 for s in servers]
        await sink.close()
        for server in servers:
            await server.stop()
        await broker.stop()
        return first, pushed, snaps

    first, pushed, (own_snap, other_snap) = asyncio.run(scenario())
    assert first == {"type": "snapshot", "payload": {
        "events": [], "generated_at": first["payload"]["generated_at"]}}
    assert [m["type"] for m in pushed] == ["event"] * len(sent)
    assert [(m["payload"]["stream"], m["payload"]["frame_id"]) for m in pushed] == [
        (s, f) for s, f, _ in sent]
    assert pushed[1]["payload"]["tracks"][1]["action_label"] == "running"
    assert _without_clocks(other_snap) == _without_clocks(own_snap)
    assert [e["stream"] for e in _without_clocks(own_snap)] == ["cam-a", "cam-b", "cam-c"]
    assert _without_clocks(own_snap)[0]["frame_id"] == 3
