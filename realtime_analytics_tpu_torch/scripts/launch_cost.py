"""What the host pays to launch one small kernel, statement by statement.

    python -m realtime_analytics_tpu_torch.scripts.launch_cost [--out FILE]

The row gather (B1) runs for under two microseconds on the card; a caller
pays the host's cost of getting it there. This script times, on the host
clock and without synchronising (the queue is drained before each round),
``row_gather`` at the two shapes ``batched_nms`` gives it, the one PyTorch
expression that computes the same function (``torch.gather``), and each
statement of the wrapper on its own: the checks, the output allocation,
the pointer reads, the stream lookup, the bound C call (which holds
``cudaLaunchKernel``) and the launch count. Each figure is the least mean
of ``--rounds`` rounds of ``--calls`` calls, in microseconds: the least,
because a shared host only ever adds time; the pieces take turns within a
round.

It needs a CUDA card and fails without one. Every number names the card
and its power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def least_us(fns: dict, calls: int, rounds: int) -> dict:
    """{name: least mean microseconds per call}. The functions take turns
    within every round, so a slow stretch of the host falls on all alike."""
    for fn in fns.values():
        for _ in range(50):
            fn()
    best = dict.fromkeys(fns, float("inf"))
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            best[name] = min(best[name], (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def measure(n: int, m: int, p: int, k: int, calls: int, rounds: int) -> dict:
    from ..ops import _cuda
    from ..ops.gather import row_gather

    gen = torch.Generator(device="cuda").manual_seed(0)
    payload = torch.randn(n, m, p, generator=gen, device="cuda")
    idx = torch.randint(0, m, (n, k), generator=gen, device="cuda")
    out = torch.empty((n, k, p), dtype=torch.float32, device="cuda")
    row_gather(payload, idx)  # builds and binds
    launch = _cuda.entry("rva_row_gather")
    dev = payload.device
    stream = _cuda.stream_of(dev.index)
    ptrs = (payload.data_ptr(), idx.data_ptr(), out.data_ptr())
    wide = idx[..., None].expand(-1, -1, p)

    def checks():  # the wrapper's own statements, in its order
        if not payload.is_cuda or idx.get_device() != payload.get_device():
            raise AssertionError
        if payload.dtype is not torch.float32 or idx.dtype is not torch.int64:
            raise AssertionError
        try:
            rows_p, _m, _p = payload.shape
            rows, _k = idx.shape
        except ValueError:
            rows_p, rows = 0, -1
        if rows != rows_p:
            raise AssertionError
        if not (payload.is_contiguous() and idx.is_contiguous()):
            raise AssertionError
        return payload.get_device()

    pieces = {
        "row_gather": lambda: row_gather(payload, idx),
        "torch_gather": lambda: torch.gather(payload, 1, idx[..., None].expand(-1, -1, p)),
        "empty_call": lambda: None,
        "checks_and_shapes": checks,
        "new_empty": lambda: payload.new_empty((n, k, p)),
        "torch_empty": lambda: torch.empty((n, k, p), dtype=torch.float32, device=dev),
        "three_data_ptr": lambda: (payload.data_ptr(), idx.data_ptr(), out.data_ptr()),
        "stream_of": lambda: _cuda.stream_of(dev.index),
        "bound_c_call_with_launch": lambda: launch(dev.index, *ptrs, n, m, k, p, stream),
        "launch_count": lambda: _cuda.LAUNCHES.add("row_gather"),
        # the one launch inside torch.gather, without the two view ops
        "torch_gather_preexpanded": lambda: torch.gather(payload, 1, wide),
    }
    with torch.inference_mode():
        return least_us(pieces, calls, rounds)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=9)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("launch_cost: no CUDA card visible — this measurement runs on the card",
              file=sys.stderr)
        return 1
    result = dict(
        card=card_line(), torch=torch.__version__, calls=args.calls, rounds=args.rounds,
        unit="microseconds per call on the host clock, least round",
        nms_first_call=measure(32, 8400, 4, 512, args.calls, args.rounds),
        nms_second_call=measure(32, 512, 6, 300, args.calls, args.rounds),
    )
    text = json.dumps(result, indent=1)
    print(text)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
