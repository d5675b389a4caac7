"""``realtime-analytics-torch`` CLI: run the port's pipeline from a YAML config.

Flag parity with the reference (scripts/run_pipeline.py:23-60), plus
``--broker`` to spawn the in-repo eventbus broker in-process when the config
uses the eventbus transport (single-box demos without Kafka). The JAX
package's ``--shards`` and ``--jax-profile`` are not ported (ROADMAP.md
Queue A items 7 and 15).

    python -m realtime_analytics_tpu_torch.scripts.run_pipeline \\
        --config config/pipeline-sim.yaml --duration 30
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
    add_logging_args(parser)
    return parser


async def _amain(args) -> int:
    from ..config import load_config
    from ..pipeline import AnalyticsPipeline

    config = load_config(args.config)
    broker = None
    if args.broker and config.kafka.enabled and config.kafka.transport == "eventbus":
        from ..sinks.eventbus import EventBusBroker

        host, _, port = config.kafka.bootstrap_servers.partition(":")
        broker = EventBusBroker(host or "127.0.0.1", int(port or 9192))
        await broker.start()

    pipeline = AnalyticsPipeline(config)
    try:
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
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        logger.info("interrupted — shut down cleanly")
        return 0


if __name__ == "__main__":
    sys.exit(main())
