"""``realtime-analytics-torch-dashboard`` CLI: serve the port's live dashboard.

Flag parity with the reference (scripts/run_dashboard.py:24-86): the kafka
section of the YAML config is merged with CLI overrides
(--kafka-bootstrap/--kafka-topic/--no-kafka), plus --host/--port and
--broker to host the eventbus broker inside the dashboard process.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import sys
from .logging_setup import add_logging_args, setup_logging

logger = logging.getLogger("realtime_analytics_tpu_torch.dashboard")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="realtime-analytics-torch-dashboard",
        description="Live WebSocket dashboard for the analytics pipeline",
    )
    parser.add_argument("--config", default=None,
                        help="pipeline YAML (its kafka section is used)")
    parser.add_argument("--kafka-bootstrap", default=None)
    parser.add_argument("--kafka-topic", default=None)
    parser.add_argument("--transport", default=None,
                        choices=["kafka", "eventbus", "jsonl"])
    parser.add_argument("--no-kafka", action="store_true",
                        help="serve the UI without any event consumer")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=8080)
    parser.add_argument("--broker", action="store_true",
                        help="host the eventbus broker in this process")
    add_logging_args(parser)
    return parser


def build_kafka_config(args) -> "KafkaSinkConfig":
    from ..config import KafkaSinkConfig, load_config

    if args.config:
        kafka = load_config(args.config).kafka
    else:
        kafka = KafkaSinkConfig(enabled=True)
    if args.kafka_bootstrap:
        kafka.bootstrap_servers = args.kafka_bootstrap
    if args.kafka_topic:
        kafka.topic = args.kafka_topic
    if args.transport:
        kafka.transport = args.transport
    if args.no_kafka:
        kafka.enabled = False
        kafka.transport = "memory"
    return kafka


async def _amain(args) -> int:
    from ..api.server import DashboardServer

    kafka = build_kafka_config(args)

    broker = None
    if args.broker and kafka.transport == "eventbus":
        from ..sinks.eventbus import EventBusBroker

        host, _, port = kafka.bootstrap_servers.partition(":")
        broker = EventBusBroker(host or "127.0.0.1", int(port or 9192))
        await broker.start()

    server = DashboardServer(kafka, host=args.host, port=args.port)
    try:
        await server.serve_forever()
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
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        logger.info("dashboard stopped")
        return 0


if __name__ == "__main__":
    sys.exit(main())
