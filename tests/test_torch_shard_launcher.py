"""The port's stream-sharding supervisor (``run_pipeline --shards K``).

``realtime_analytics_tpu_torch.scripts.run_pipeline --shards K`` starts K
pipeline processes of the port that split the stream list round-robin and
publish to one event bus. The unit cases replace ``subprocess.Popen`` with a
recorder and start no process: they hold the split against the JAX
package's, and the children's commands and environments against what the
port decides (its own module, ``--torch-profile``, ``CUDA_VISIBLE_DEVICES``).
The two integration cases run the real launcher on the CPU, as
tests/test_shard_launcher.py does for the JAX package; ``chip_smoke.py``
runs the same path on the card.
"""

import asyncio
import logging
import os
import signal
import subprocess
import sys
import time

import pytest
import yaml

from realtime_analytics_tpu.config import load_config as jax_load_config
from realtime_analytics_tpu.scripts.run_pipeline import shard_config as jax_shard_config
from realtime_analytics_tpu_torch.config import load_config
from realtime_analytics_tpu_torch.scripts import run_dashboard
from realtime_analytics_tpu_torch.scripts import run_pipeline as rp
from realtime_analytics_tpu_torch.scripts.run_pipeline import shard_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUS_PORT = 19421  # tests/test_shard_launcher.py holds 19411
MODULE = "realtime_analytics_tpu_torch.scripts.run_pipeline"


def _config_dict(n_streams=4, frames=40):
    return {
        "streams": [
            {
                "name": f"cam-{i}",
                "url": f"synthetic://?width=96&height=64&frames={frames}&seed={i}",
                "target_fps": 30,
                "warmup_seconds": 0.0,
                "max_retries": 0,
                "batch_size": 2,
            }
            for i in range(n_streams)
        ],
        "detector": {
            "model_path": "__random__.pt",
            "device": "cpu",
            "confidence_threshold": 0.005,
            "input_size": [64, 64],
            "max_batch_size": 2,
            "batch_buckets": [2],
            "precision": "fp32",
            "warmup": False,
            "pre_nms_topk": 64,
            "max_detections": 8,
        },
        "tracker": {"min_hits": 1},
        "kafka": {
            "enabled": True,
            "transport": "eventbus",
            "bootstrap_servers": f"127.0.0.1:{BUS_PORT}",
            "topic": "analytics.events",
            "include_frames": False,
        },
        "prometheus": {"enabled": False},
        "snapshots": {"enabled": False},
        "stats_interval_seconds": 60,
    }


def _write(tmp_path, d) -> str:
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(d))
    return str(path)


# --------------------------------------------------------------- the split


def test_shard_config_splits_round_robin(tmp_path):
    path = _write(tmp_path, _config_dict(5))
    got = {}
    for i in range(2):
        cfg = shard_config(load_config(path), i, 2)
        got[i] = [s.name for s in cfg.streams]
    assert got[0] == ["cam-0", "cam-2", "cam-4"]
    assert got[1] == ["cam-1", "cam-3"]


def test_shard_config_offsets_prometheus_port(tmp_path):
    d = _config_dict(4)
    d["prometheus"] = {"enabled": True, "port": 9400}
    path = _write(tmp_path, d)
    assert shard_config(load_config(path), 0, 2).prometheus.port == 9400
    assert shard_config(load_config(path), 1, 2).prometheus.port == 9401


@pytest.mark.parametrize("n_streams,count", [(5, 2), (32, 2), (32, 4), (7, 3)])
def test_shard_config_matches_jax_split(tmp_path, n_streams, count):
    d = _config_dict(n_streams)
    d["streams"][1]["enabled"] = False  # disabled streams take no slot
    d["prometheus"] = {"enabled": True, "port": 9500}
    path = _write(tmp_path, d)
    for i in range(count):
        got = shard_config(load_config(path), i, count)
        want = jax_shard_config(jax_load_config(path), i, count)
        assert [s.name for s in got.streams] == [s.name for s in want.streams]
        assert got.prometheus.port == want.prometheus.port == 9500 + i


# ------------------------------------------- the supervisor, Popen recorded


class _Proc:
    """A child that has already exited with its return code."""

    def __init__(self, rc):
        self.returncode = rc

    def poll(self):
        return self.returncode

    def terminate(self):
        pass

    def wait(self):
        return self.returncode


@pytest.fixture
def supervise(monkeypatch, tmp_path):
    """Run ``run_shards`` on argv with Popen recorded; returns the exit code
    and the children as (command, environment) pairs, in spawn order."""

    def run(argv, rcs=None, bus_up=True, n_streams=4):
        path = _write(tmp_path, _config_dict(n_streams))
        spawned = []
        rcs = dict(rcs or {})

        def popen(cmd, env=None, **_kw):
            i = int(cmd[cmd.index("--shard-index") + 1])
            codes = rcs.get(i, [0])
            spawned.append((cmd, env))
            return _Proc(codes.pop(0) if len(codes) > 1 else codes[0])

        monkeypatch.setattr(subprocess, "Popen", popen)
        monkeypatch.setattr(signal, "signal", lambda *_a: None)
        monkeypatch.setattr(time, "sleep", lambda _s: None)
        monkeypatch.setattr(rp, "_wait_for_port", lambda *_a, **_k: bus_up)
        args = rp.build_parser().parse_args(["--config", path] + argv)
        return rp.run_shards(args), spawned, path

    return run


def _flag(cmd, name):
    return cmd[cmd.index(name) + 1] if name in cmd else None


@pytest.mark.parametrize("k", [2, 3, 4])
def test_children_run_the_ports_pipeline_module(supervise, k):
    rc, spawned, path = supervise(["--shards", str(k)])
    assert rc == 0
    assert len(spawned) == k
    for i, (cmd, _env) in enumerate(spawned):
        assert cmd[:3] == [sys.executable, "-m", MODULE]
        assert _flag(cmd, "--config") == path
        assert _flag(cmd, "--shard-index") == str(i)
        assert _flag(cmd, "--shard-count") == str(k)
        assert _flag(cmd, "--log-level") == "INFO"
        assert "--shards" not in cmd  # a child never supervises


def test_shards_clamped_to_enabled_streams(supervise):
    _rc, spawned, _path = supervise(["--shards", "8"], n_streams=3)
    assert [_flag(cmd, "--shard-count") for cmd, _ in spawned] == ["3"] * 3


def test_broker_goes_to_shard_zero_only(supervise):
    _rc, spawned, _path = supervise(["--shards", "3", "--broker"])
    assert ["--broker" in cmd for cmd, _ in spawned] == [True, False, False]
    _rc, spawned, _path = supervise(["--shards", "3"])
    assert not any("--broker" in cmd for cmd, _ in spawned)


@pytest.mark.parametrize("argv,flag,per_shard", [
    (["--torch-profile", "/p"], "--torch-profile", ["/p/shard0", "/p/shard1"]),
    (["--log-file", "run.log"], "--log-file", ["run.log.shard0", "run.log.shard1"]),
    (["--log-format", "json"], "--log-format", ["json", "json"]),
    (["--duration", "7.5"], "--duration", ["7.5", "7.5"]),
    (["--log-level", "DEBUG"], "--log-level", ["DEBUG", "DEBUG"]),
])
def test_observability_flags_reach_every_shard(supervise, argv, flag, per_shard):
    _rc, spawned, _path = supervise(["--shards", "2"] + argv)
    assert [_flag(cmd, flag) for cmd, _ in spawned] == per_shard


def test_defaults_forward_nothing_extra(supervise):
    _rc, spawned, _path = supervise(["--shards", "2"])
    for cmd, _env in spawned:
        for flag in ("--torch-profile", "--log-file", "--log-format",
                     "--duration", "--log-rotate", "--no-color", "--broker"):
            assert flag not in cmd


@pytest.mark.parametrize("flag", ["--log-rotate", "--no-color"])
def test_switches_reach_every_shard(supervise, flag):
    _rc, spawned, _path = supervise(["--shards", "2", flag])
    assert all(flag in cmd for cmd, _ in spawned)


def test_each_child_gets_its_shard_index(supervise, monkeypatch):
    monkeypatch.setenv("RVA_TEST_MARK", "kept")
    _rc, spawned, _path = supervise(["--shards", "3"])
    assert [env["RVA_SHARD_INDEX"] for _, env in spawned] == ["0", "1", "2"]
    assert all(env["RVA_TEST_MARK"] == "kept" for _, env in spawned)


def test_cuda_device_env_pins_shard_i_to_card_i(supervise, monkeypatch):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    _rc, spawned, _path = supervise(["--shards", "4", "--shard-device-env", "cuda"])
    assert [env["CUDA_VISIBLE_DEVICES"] for _, env in spawned] == ["0", "1", "2", "3"]


@pytest.mark.parametrize("visible", [None, "0"])
def test_device_env_none_leaves_the_environment(supervise, monkeypatch, visible):
    if visible is None:
        monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    else:
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", visible)
    _rc, spawned, _path = supervise(["--shards", "2"])
    for i, (_cmd, env) in enumerate(spawned):
        assert env == dict(os.environ, RVA_SHARD_INDEX=str(i))


def test_tpu_device_env_is_not_a_choice():
    with pytest.raises(SystemExit):
        rp.build_parser().parse_args(["--config", "c.yaml", "--shard-device-env", "tpu"])


@pytest.mark.parametrize("rcs,want", [
    ({}, 0),
    ({1: [3]}, 3),
    ({0: [-15], 1: [2]}, 15),  # a signal's death counts by its number
])
def test_exit_code_is_the_worst_childs(supervise, rcs, want):
    rc, _spawned, _path = supervise(["--shards", "2"], rcs=rcs)
    assert rc == want


def test_bus_never_up_aborts_the_other_shards(supervise):
    rc, spawned, _path = supervise(["--shards", "3", "--broker"],
                                   rcs={0: [0]}, bus_up=False)
    assert len(spawned) == 1 and rc == 1


def test_shard_restart_revives_a_crashed_shard(supervise):
    rc, spawned, _path = supervise(["--shards", "2", "--shard-restart"],
                                   rcs={1: [9, 0]})
    assert [_flag(cmd, "--shard-index") for cmd, _ in spawned] == ["0", "1", "1"]
    assert rc == 0


def test_without_restart_a_crash_is_final(supervise):
    rc, spawned, _path = supervise(["--shards", "2"], rcs={1: [9, 0]})
    assert len(spawned) == 2 and rc == 9


# ------------------------------------------------ main's dispatch, a shard


def test_main_dispatches_to_the_supervisor(monkeypatch, tmp_path):
    path = _write(tmp_path, _config_dict(4))
    monkeypatch.setattr(rp, "setup_logging", lambda **_k: None)
    monkeypatch.setattr(rp, "run_shards", lambda args: 40 + args.shards)
    assert rp.main(["--config", path, "--shards", "2"]) == 42
    ran = []

    async def amain(args):
        ran.append((args.shard_index, args.shard_count))
        return 0

    monkeypatch.setattr(rp, "_amain", amain)
    assert rp.main(["--config", path, "--shards", "2", "--shard-index", "1",
                    "--shard-count", "2"]) == 0
    assert rp.main(["--config", path, "--shards", "1"]) == 0
    assert ran == [(1, 2), (None, None)]


def test_a_shard_serves_its_share_and_logs_it(monkeypatch, tmp_path, caplog):
    import realtime_analytics_tpu_torch.pipeline as pipeline_mod

    served = []

    class FakePipeline:
        def __init__(self, config):
            served.append([s.name for s in config.streams])

        async def run_for(self, seconds):
            served.append(seconds)

    monkeypatch.setattr(pipeline_mod, "AnalyticsPipeline", FakePipeline)
    path = _write(tmp_path, _config_dict(5))
    args = rp.build_parser().parse_args(
        ["--config", path, "--shard-index", "1", "--shard-count", "2",
         "--duration", "3"])
    with caplog.at_level(logging.INFO, logger="realtime_analytics_tpu_torch.cli"):
        assert asyncio.run(rp._amain(args)) == 0
    assert served == [["cam-1", "cam-3"], 3.0]
    assert "shard 1/2: serving 2 streams" in caplog.text


# ------------------------------------------------- run_dashboard's config


@pytest.mark.parametrize("use_config,argv,want", [
    (False, [], dict(enabled=True, transport="kafka", topic="analytics")),
    (True, [], dict(enabled=True, transport="eventbus",
                    bootstrap_servers=f"127.0.0.1:{BUS_PORT}")),
    (True, ["--kafka-bootstrap", "10.0.0.5:9000", "--kafka-topic", "t2",
            "--transport", "jsonl"],
     dict(enabled=True, transport="jsonl", bootstrap_servers="10.0.0.5:9000",
          topic="t2")),
    (True, ["--no-kafka"], dict(enabled=False, transport="memory")),
])
def test_dashboard_kafka_config(tmp_path, use_config, argv, want):
    if use_config:
        argv = ["--config", _write(tmp_path, _config_dict(2))] + argv
    kafka = run_dashboard.build_kafka_config(run_dashboard.build_parser().parse_args(argv))
    for key, value in want.items():
        assert getattr(kafka, key) == value, key


# ----------------------------------------------- the real launcher, CPU


def _launch(tmp_path, n_streams, extra, out_f):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(_config_dict(n_streams, frames=0)))  # endless
    env = dict(os.environ, OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", MODULE, "--config", str(path), "--shards", "2",
         "--broker", "--log-level", "INFO"] + extra,
        cwd=REPO, env=env, stdout=out_f, stderr=subprocess.STDOUT, text=True,
    )


@pytest.mark.slow
def test_launcher_runs_two_shards_one_bus(tmp_path):
    """Two shards of the port on the CPU publish four streams to one bus;
    the window opens only once both log "Pipeline started", as the JAX
    package's case does."""
    out_path = tmp_path / "launcher.log"
    with open(out_path, "w") as out_f:
        proc = _launch(tmp_path, 4, ["--duration", "600"], out_f)

    def log_text():
        return out_path.read_text(errors="replace")

    deadline = time.monotonic() + 600
    while log_text().count("Pipeline started") < 2:
        if proc.poll() is not None:
            pytest.fail(f"launcher exited rc={proc.returncode} before both "
                        f"shards started:\n{log_text()[-2000:]}")
        if time.monotonic() > deadline:
            proc.send_signal(signal.SIGTERM)
            proc.communicate(timeout=120)
            pytest.fail(f"shards not up in 600s:\n{log_text()[-2000:]}")
        time.sleep(0.5)

    streams_seen = set()

    async def consume():
        from realtime_analytics_tpu_torch.sinks.eventbus import EventBusSubscriber

        sub = EventBusSubscriber("127.0.0.1", BUS_PORT, "analytics.events")
        await sub.connect()
        try:
            async with asyncio.timeout(120):
                async for payload in sub.messages():
                    if payload and "stream" in payload:
                        streams_seen.add(payload["stream"])
                    if len(streams_seen) == 4:
                        return
        except TimeoutError:
            pass
        finally:
            await sub.close()

    try:
        asyncio.run(consume())
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=120)

    out = log_text()
    assert streams_seen == {"cam-0", "cam-1", "cam-2", "cam-3"}, out[-2000:]
    assert "shard 0/2: serving 2 streams" in out
    assert "shard 1/2: serving 2 streams" in out
    assert proc.returncode == 0, out[-2000:]


@pytest.mark.slow
def test_shard_restart_revives_crashed_shard(tmp_path):
    """--shard-restart: shard 1 killed mid-run comes back."""
    out_path = tmp_path / "launcher.log"
    with open(out_path, "w") as out_f:
        proc = _launch(tmp_path, 2, ["--shard-restart", "--duration", "300"], out_f)

    def shard1_pids():
        out = subprocess.run(["pgrep", "-P", str(proc.pid), "-f", "shard-index 1"],
                             capture_output=True, text=True)
        return [int(p) for p in out.stdout.split() if p.strip()]

    try:
        killed = []
        deadline = time.time() + 100
        while time.time() < deadline and not killed:
            time.sleep(2.0)
            for pid in shard1_pids():
                os.kill(pid, signal.SIGKILL)
                killed.append(pid)
        assert killed, "never found the shard-1 child to kill"
        revived = []
        deadline = time.time() + 90
        while time.time() < deadline and not revived:
            time.sleep(2.0)
            revived = [p for p in shard1_pids() if p not in killed]
        assert revived, "shard 1 was not restarted"
    finally:
        proc.send_signal(signal.SIGTERM)
        proc.communicate(timeout=60)
    assert "restarting in 5 s" in out_path.read_text(errors="replace")
