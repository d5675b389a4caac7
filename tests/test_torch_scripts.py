"""The port's host scripts on the CPU: the cases of tests/test_scripts.py
on the copies (logging suite, config generator, encoding checker), the
event simulator and demo-video writer, the profiling hook, and the
temporal-detector harness with ``--device cpu``."""

import asyncio
import contextlib
import io
import json
import logging
import random

import numpy as np
import yaml

from realtime_analytics_tpu_torch.config import config_from_dict
from realtime_analytics_tpu_torch.scripts.check_encoding import scan
from realtime_analytics_tpu_torch.scripts.gen_streams import build_config
from realtime_analytics_tpu_torch.scripts.logging_setup import (
    ColoredFormatter,
    JsonFormatter,
    setup_logging,
)


def _record(level=logging.INFO, msg="hello %s", args=("world",)):
    return logging.LogRecord("t", level, "f.py", 1, msg, args, None)


def test_json_formatter_emits_valid_json():
    out = json.loads(JsonFormatter().format(_record()))
    assert out["level"] == "INFO"
    assert out["message"] == "hello world"
    assert "ts" in out


def test_colored_formatter_wraps_with_ansi():
    f = ColoredFormatter("%(levelname)s %(message)s")
    text = f.format(_record(logging.ERROR, "boom", ()))
    assert text.startswith("\033[31m") and text.endswith("\033[0m")


def test_setup_logging_rotating_file(tmp_path):
    log_file = tmp_path / "p.log"
    setup_logging(level="DEBUG", log_file=str(log_file), log_format="detailed")
    logging.getLogger("x").warning("written to file")
    for h in logging.getLogger().handlers:
        h.flush()
    assert "written to file" in log_file.read_text()
    # reset to defaults for other tests
    setup_logging(level="WARNING")


def test_gen_streams_config_is_valid():
    raw = build_config(32, "rtsp://127.0.0.1:{port}/cam-{i:02d}", 8554, 25.0,
                       synthetic=False)
    # round-trips through YAML and validates
    cfg = config_from_dict(yaml.safe_load(yaml.safe_dump(raw)))
    assert len(cfg.streams) == 32
    assert cfg.streams[0].url == "rtsp://127.0.0.1:8554/cam-00"
    assert cfg.streams[31].url == "rtsp://127.0.0.1:8585/cam-31"
    assert cfg.detector.max_batch_size == 32

    synth = build_config(4, "", 0, 10.0, synthetic=True)
    cfg2 = config_from_dict(synth)
    assert cfg2.streams[0].url.startswith("synthetic://")


def test_gen_streams_writes_what_the_jax_generator_writes():
    from realtime_analytics_tpu.scripts.gen_streams import build_config as jax_build

    for args in ((8, "rtsp://h:{port}/c{i}", 9000, 12.5, False), (3, "", 0, 25.0, True)):
        assert build_config(*args) == jax_build(*args)


def test_check_encoding(tmp_path):
    (tmp_path / "good.py").write_text("x = 'ok'\n", encoding="utf-8")
    (tmp_path / "bom.md").write_bytes(b"\xef\xbb\xbfhello")
    (tmp_path / "bad.txt").write_bytes(b"\xff\xfe invalid \x80")
    report = scan(tmp_path)
    assert report["checked"] == 3
    issues = {i["file"]: i["issue"] for i in report["issues"]}
    assert issues["bom.md"] == "utf8-bom"
    assert "invalid-utf8" in issues["bad.txt"]
    assert "good.py" not in issues


def test_simulate_data_events_equal_jax_and_reach_the_bus():
    from realtime_analytics_tpu.scripts.simulate_data import make_event as jax_event
    from realtime_analytics_tpu_torch.scripts.simulate_data import amain, make_event
    from realtime_analytics_tpu_torch.sinks.eventbus import (
        EventBusBroker,
        EventBusSubscriber,
    )

    a, b = random.Random(4), random.Random(4)
    for i in range(20):
        assert make_event("cam-00", i, a) == jax_event("cam-00", i, b)

    async def run():
        broker = EventBusBroker("127.0.0.1", 0)
        await broker.start()
        sub = EventBusSubscriber("127.0.0.1", broker.port, "t")
        await sub.connect()
        await asyncio.sleep(0.05)

        class Args:
            seed, streams, rate, duration, topic = 0, 2, 100.0, 0.3, "t"
            bootstrap = f"127.0.0.1:{broker.port}"

        with contextlib.redirect_stdout(io.StringIO()):
            assert await amain(Args) == 0
        first = await asyncio.wait_for(sub.messages().__anext__(), timeout=5)
        await sub.close()
        await broker.stop()
        return first

    event = asyncio.run(run())
    assert event["stream"] in ("cam-00", "cam-01") and event["frame_id"] == 1


def test_make_demo_video_writes_readable_frames(tmp_path):
    import cv2

    from realtime_analytics_tpu_torch.scripts.make_demo_video import main

    out = tmp_path / "demo.mp4"
    with contextlib.redirect_stdout(io.StringIO()):
        assert main(["--out", str(out), "--seconds", "0.4", "--fps", "10",
                     "--width", "96", "--height", "64", "--boxes", "2"]) == 0
    cap = cv2.VideoCapture(str(out))
    frames = 0
    while cap.read()[0]:
        frames += 1
    cap.release()
    assert frames == 4


def test_torch_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    from realtime_analytics_tpu_torch.utils.profiling import torch_trace

    with torch_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list((tmp_path / "trace").glob("trace-*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    with torch_trace(None):  # no logdir: no trace
        pass


def test_run_pipeline_takes_torch_profile():
    from realtime_analytics_tpu_torch.scripts.run_pipeline import build_parser

    args = build_parser().parse_args(["--config", "c.yaml", "--torch-profile", "/t"])
    assert args.torch_profile == "/t"


def test_temporal_detector_harness_runs_a_tiny_clip():
    from realtime_analytics_tpu_torch.scripts.test_temporal_detector import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["--model-type", "cnn_lstm", "--device", "cpu",
                   "--source", "synthetic://?width=96&height=64&boxes=2",
                   "--frames", "12", "--sequence-length", "4", "--overlap", "0.5",
                   "--num-classes", "5", "--warmup", "0"])
    text = buf.getvalue()
    assert rc == 0
    clips = [line for line in text.splitlines() if line.startswith("frame ")]
    assert len(clips) >= 3, text
    assert "infer latency avg/min/max" in text
    assert np.isfinite(float(clips[0].split("score=")[1].split()[0]))
