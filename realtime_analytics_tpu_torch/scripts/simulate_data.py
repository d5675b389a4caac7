"""Push mock detection events at the dashboard (reference simulate_data.py).

Publishes schema-correct events (integer class ids — fixing the reference's
string class_id divergence, simulate_data.py:44-87) to the eventbus or a
JSONL file so the dashboard can be demoed without running the pipeline.

Usage:
  python -m realtime_analytics_tpu_torch.scripts.simulate_data \
      --bootstrap 127.0.0.1:9192 --streams 32 --rate 10
"""

from __future__ import annotations

import argparse
import asyncio
import random
import sys
import time


def make_event(stream: str, frame_id: int, rng: random.Random) -> dict:
    n = rng.randint(0, 6)
    tracks = []
    for t in range(n):
        x1 = rng.uniform(0, 1700)
        y1 = rng.uniform(0, 900)
        tracks.append(
            {
                "track_id": rng.randint(1, 500),
                "class_id": rng.choice([0, 1, 2, 3, 5, 7]),
                "confidence": round(rng.uniform(0.3, 0.99), 4),
                "bbox_xyxy": [
                    round(x1, 1), round(y1, 1),
                    round(x1 + rng.uniform(40, 200), 1),
                    round(y1 + rng.uniform(40, 180), 1),
                ],
            }
        )
    return {
        "stream": stream,
        "frame_id": frame_id,
        "tracks": tracks,
        "is_temporal": False,
    }


async def amain(args) -> int:
    from realtime_analytics_tpu_torch.sinks.eventbus import EventBusPublisher

    rng = random.Random(args.seed)
    host, _, port = args.bootstrap.partition(":")
    pub = EventBusPublisher(host or "127.0.0.1", int(port or 9192))
    await pub.connect()
    names = [f"cam-{i:02d}" for i in range(args.streams)]
    frame_ids = {n: 0 for n in names}
    interval = 1.0 / args.rate
    print(f"publishing ~{args.rate}/s to topic '{args.topic}' ({args.streams} streams)")
    t_end = time.time() + args.duration if args.duration else None
    try:
        while t_end is None or time.time() < t_end:
            name = rng.choice(names)
            frame_ids[name] += 1
            await pub.publish(args.topic, make_event(name, frame_ids[name], rng))
            await asyncio.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        await pub.close()
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--bootstrap", default="127.0.0.1:9192")
    p.add_argument("--topic", default="analytics.events")
    p.add_argument("--streams", type=int, default=8)
    p.add_argument("--rate", type=float, default=10.0, help="events per second")
    p.add_argument("--duration", type=float, default=0.0, help="0 = forever")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    try:
        return asyncio.run(amain(args))
    except KeyboardInterrupt:
        # Ctrl-C raises at the event-loop level (the in-coroutine handler
        # never sees it under asyncio.run); exit clean like run_pipeline
        return 0


if __name__ == "__main__":
    sys.exit(main())
