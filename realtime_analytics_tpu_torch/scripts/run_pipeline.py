"""``realtime-analytics-torch`` CLI: run the port's pipeline from a YAML config.

Flag parity with the reference (scripts/run_pipeline.py:23-60), plus
``--broker`` to spawn the in-repo eventbus broker in-process when the config
uses the eventbus transport (single-box demos without Kafka),
``--torch-profile DIR`` (a ``torch.profiler`` Chrome trace of the run, the
JAX package's ``--jax-profile``) and ``--shards K``: a supervisor that starts
K pipeline processes, which split the stream list round-robin and publish to
one event bus. They share one card unless ``--shard-device-env cuda`` pins
shard i to card i.

    python -m realtime_analytics_tpu_torch.scripts.run_pipeline \\
        --config config/pipeline-sim.yaml --duration 30
    python -m realtime_analytics_tpu_torch.scripts.run_pipeline \\
        --config config/pipeline-sim.yaml --shards 2 --broker
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys

from .logging_setup import add_logging_args, setup_logging

logger = logging.getLogger("realtime_analytics_tpu_torch.cli")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="realtime-analytics-torch",
        description="Multi-stream realtime video analytics pipeline "
                    "(PyTorch / CUDA)",
    )
    parser.add_argument("--config", required=True, help="pipeline YAML config path")
    parser.add_argument(
        "--broker", action="store_true",
        help="start the in-process eventbus broker (when transport=eventbus)",
    )
    parser.add_argument(
        "--duration", type=float, default=None,
        help="run for N seconds then exit (default: run until SIGINT/SIGTERM)",
    )
    parser.add_argument(
        "--shards", type=int, default=None, metavar="K",
        help="supervisor mode: spawn K pipeline processes that split the "
             "stream list round-robin and publish to one shared bus (one "
             "process per card on a multi-card host)",
    )
    parser.add_argument(
        "--shard-device-env", choices=["none", "cuda"], default="none",
        help="with --shards on a multi-card host: 'cuda' pins shard i to "
             "card i via CUDA_VISIBLE_DEVICES ('none': all shards share "
             "the visible cards)",
    )
    parser.add_argument(
        "--shard-restart", action="store_true",
        help="restart a shard that exits non-zero (the in-process analog of "
             "docker restart: unless-stopped), 5 s backoff",
    )
    parser.add_argument(
        "--shard-index", type=int, default=None, help=argparse.SUPPRESS,
    )
    parser.add_argument(
        "--shard-count", type=int, default=None, help=argparse.SUPPRESS,
    )
    parser.add_argument(
        "--torch-profile", default=None, metavar="DIR",
        help="capture a torch.profiler trace of the run into DIR",
    )
    add_logging_args(parser)
    return parser


def shard_config(config, index: int, count: int):
    """Restrict a pipeline config to shard ``index`` of ``count``: enabled
    streams split round-robin; the Prometheus port offsets by the shard
    index so every shard exports metrics."""
    enabled = [s for s in config.streams if s.enabled]
    keep = {s.name for i, s in enumerate(enabled) if i % count == index}
    config.streams = [s for s in config.streams if s.name in keep]
    if config.prometheus.enabled:
        config.prometheus.port += index
    return config


def _wait_for_port(host: str, port: int, timeout_s: float = 30.0) -> bool:
    import socket
    import time as _time

    deadline = _time.monotonic() + timeout_s
    while _time.monotonic() < deadline:
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            _time.sleep(0.2)
    return False


def run_shards(args) -> int:
    """Supervisor: one pipeline process per shard, one shared bus.

    Shard 0 hosts the eventbus broker (when --broker); the others spawn
    once the bus port answers, so no shard races the broker. Signals are
    forwarded; the supervisor exits with the worst child rc.
    """
    import os
    import signal
    import subprocess

    from ..config import load_config

    config = load_config(args.config)
    n_enabled = sum(1 for s in config.streams if s.enabled)
    k = max(1, min(args.shards, n_enabled))
    logger.info("supervisor: %d shards over %d streams", k, n_enabled)

    def cmd(i: int):
        c = [sys.executable, "-m", "realtime_analytics_tpu_torch.scripts.run_pipeline",
             "--config", args.config,
             "--shard-index", str(i), "--shard-count", str(k),
             "--log-level", args.log_level]
        # observability flags must reach the shards — they do the actual
        # work; a supervisor-only --log-file/--torch-profile captures nothing
        if args.log_format != "standard":
            c += ["--log-format", args.log_format]
        if args.log_file:
            c += ["--log-file", f"{args.log_file}.shard{i}"]
        if args.log_rotate:
            c += ["--log-rotate"]
        if args.no_color:
            c += ["--no-color"]
        if args.torch_profile:
            c += ["--torch-profile", f"{args.torch_profile}/shard{i}"]
        if args.duration:
            c += ["--duration", str(args.duration)]
        if i == 0 and args.broker:
            c += ["--broker"]
        return c

    def env_for(i: int):
        env = dict(os.environ)
        env["RVA_SHARD_INDEX"] = str(i)
        if args.shard_device_env == "cuda":
            env["CUDA_VISIBLE_DEVICES"] = str(i)
        return env

    procs = {0: subprocess.Popen(cmd(0), env=env_for(0))}
    if args.broker and config.kafka.enabled and config.kafka.transport == "eventbus":
        host, _, port = config.kafka.bootstrap_servers.partition(":")
        if not _wait_for_port(host or "127.0.0.1", int(port or 9192)):
            logger.error("bus port never came up — aborting remaining shards")
            procs[0].terminate()
            return procs[0].wait() or 1
    for i in range(1, k):
        procs[i] = subprocess.Popen(cmd(i), env=env_for(i))

    stopping = {"flag": False}

    def forward(signum, _frame):
        stopping["flag"] = True
        for p in procs.values():
            if p.poll() is None:
                p.send_signal(signum)

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, forward)

    import time as _time

    rcs = {}
    while len(rcs) < k:
        for i, p in list(procs.items()):
            if i in rcs:
                continue
            rc = p.poll()
            if rc is None:
                continue
            if rc != 0 and args.shard_restart and not stopping["flag"]:
                # unless-stopped semantics: crashed shards come back
                logger.warning(
                    "shard %d exited rc=%d — restarting in 5 s", i, rc
                )
                _time.sleep(5.0)
                if not stopping["flag"]:
                    child = subprocess.Popen(cmd(i), env=env_for(i))
                    procs[i] = child
                    if stopping["flag"]:
                        # a signal landed during Popen: forward() only saw
                        # the old (dead) proc, so terminate the newborn here
                        child.terminate()
                    continue
            rcs[i] = rc
        _time.sleep(0.3)
    logger.info("supervisor: shard exit codes %s",
                [rcs[i] for i in range(k)])
    return max(abs(rc) for rc in rcs.values())


async def _amain(args) -> int:
    from ..config import load_config
    from ..pipeline import AnalyticsPipeline

    config = load_config(args.config)
    if args.shard_index is not None and args.shard_count:
        config = shard_config(config, args.shard_index, args.shard_count)
        logger.info(
            "shard %d/%d: serving %d streams",
            args.shard_index, args.shard_count, len(config.streams),
        )

    broker = None
    if args.broker and config.kafka.enabled and config.kafka.transport == "eventbus":
        from ..sinks.eventbus import EventBusBroker

        host, _, port = config.kafka.bootstrap_servers.partition(":")
        broker = EventBusBroker(host or "127.0.0.1", int(port or 9192))
        await broker.start()

    from ..utils.profiling import torch_trace

    pipeline = AnalyticsPipeline(config)
    try:
        with torch_trace(args.torch_profile):
            if args.duration:
                await pipeline.run_for(args.duration)
            else:
                await pipeline.run_forever()
    finally:
        if broker is not None:
            await broker.stop()
    return 0


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    setup_logging(
        level=args.log_level,
        log_file=args.log_file,
        log_format=args.log_format,
        rotate=args.log_rotate,  # reference semantics: rotation is opt-in
        no_color=args.no_color,
    )
    try:
        if args.shards and args.shards > 1 and args.shard_index is None:
            return run_shards(args)
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        logger.info("interrupted — shut down cleanly")
        return 0


if __name__ == "__main__":
    sys.exit(main())
