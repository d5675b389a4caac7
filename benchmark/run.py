"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``realtime_analytics_tpu_torch``. The
run makes the cell's weights and frames from ``--seed``, builds the
program's serving path as the cell's traffic driver sets it up (the set-up,
timed as ``setup_s`` from the process's start), measures ``--seconds``
seconds of the traffic, then checks what the timed path served against the
plain fp32 reference and prints one JSON line last on standard output:

``{"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
"card", "checks"}``

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones, read from a ``torch.profiler`` trace of the window's last
seconds (``trace.py``) and from the program's counters. ``checks`` gives
each number compared with its limit; the same lines end standard error.

What differs per model lives in the configuration's model kind
(``kinds/<kind>.py``, found by ``cells.Cell.kind``): the seeded weights,
the engine's settings, the comparison with the kind's plain reference and
its verdict, and the control of the check. This file holds none of it. A
model of another kind is new files only: its kind ``kinds/<kind>.py``, its
plain reference ``reference/<model>.py`` (fp32 torch, importing neither JAX
nor the program), its configuration ``configs/<name>.json``, a driver under
``traffic/`` where neither present one serves it, a mix, a cell and its
metrics.

It exits non-zero with no result where no CUDA card is visible, where the
cell asks for more cards than there are, where the checkout holds no
program (one installed elsewhere is not the one under test), and
where the process holds ``jax``, ``jaxlib``, ``flax`` or the JAX package
once the window has closed. Every build and kernel cache of the program
lives under the checkout's ``build/`` (``cache_env``).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List

ROOT = Path(__file__).resolve().parents[1]  # the checkout
FORBIDDEN = ("jax", "jaxlib", "flax", "realtime_analytics_tpu")


def process_start_wall() -> float:
    """The wall-clock time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(float(line.split()[1]) for line in f if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def cache_env(root: Path = ROOT) -> None:
    """Fixed cache directories inside the checkout for every build the
    program makes: the CUDA kernels (``nvcc``), the host pick (``cc``), and
    Triton's and torch's extension caches."""
    build = root / "build"
    os.environ["RVA_TORCH_KERNELS_DIR"] = str(build / "torch_kernels")
    os.environ["RVA_NATIVE_CACHE"] = str(build / "native")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


class Context:
    """What a traffic driver is handed: the cell, its model kind
    (``model_kind``), the seed, the window's length, the device, the tracer,
    and the helpers that make the cell's inputs. The driver calls
    ``open_window`` when set-up is done and reports its readings in the dict
    it returns."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: str,
                 workdir: str):
        from .trace import SECONDS, Tracer

        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.model_kind = cell.kind()
        self.seed, self.seconds, self.device, self.workdir = seed, seconds, device, workdir
        self.tracer = Tracer(trace)
        self.tracer_seconds = min(SECONDS, seconds)
        self.state_dict = None
        self.t_open = self.t_open_wall = None

    def checkpoint(self) -> str:
        """The cell's seeded checkpoint, by its model kind."""
        return self.model_kind.checkpoint(self)

    def detector_config(self, model_path: str, buckets, warmup: bool):
        """The program's engine settings, by the cell's model kind."""
        return self.model_kind.detector_config(self, model_path, buckets, warmup)

    def open_window(self) -> float:
        """Set-up ends: the measured window starts now (host clock)."""
        self.t_open, self.t_open_wall = time.perf_counter(), time.time()
        return self.t_open

    @property
    def t_close(self) -> float:
        return self.t_open + self.seconds


class Run:
    """What the metric readers read: the cell, its configuration and mix,
    the window, the driver's readings (``readings``), the trace summary
    (``trace``, empty without ``--trace 1``), nvidia-smi's card line and
    torch's name of the device (``kind``)."""

    def __init__(self, cell, seed, seconds, setup_s, readings, trace, card, kind):
        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.seed, self.window_s, self.setup_s = seed, seconds, setup_s
        self.readings, self.trace, self.card, self.kind = readings, trace or {}, card, kind


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> Dict:
    """Run ``cell`` once and return its result line (a dict); ``setup_s``
    counts from the process's start."""
    import torch

    started = process_start_wall()
    cuda = device.startswith("cuda")
    card = card_line() if cuda else "cpu"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory(prefix="benchmark-") as workdir:
        ctx = Context(cell, seed, seconds, trace, device, workdir)
        readings = cell.driver().run(ctx)
        setup_s = ctx.t_open_wall - started
        model_kind, state_dict, summary = ctx.model_kind, ctx.state_dict, ctx.tracer.summary
        samples = readings.pop("samples")
        del ctx
        gc.collect()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.empty_cache()
        checks = model_kind.check(cell.config, state_dict, samples, device)
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    run = Run(cell, seed, readings["window_s"], setup_s, readings, summary, card, kind)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        reader = cell.metric(name)
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": reader.UNIT}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": kind,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": model_kind.passes(checks), "attempted": int(readings["attempted"]),
              "failed": int(readings["failed"]), "metrics": metrics, "device": dev}
    if trace and summary:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = summary["breakdown"]
    result["card"] = card
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cache_env()
    os.environ.setdefault("USE_FLAX", "0")

    from .cells import load_cell

    cell = load_cell(args.workload)
    try:
        import realtime_analytics_tpu_torch as program
    except ImportError as exc:
        print(f"benchmark: the program is missing: {exc}", file=sys.stderr)
        return 3
    if ROOT not in Path(program.__file__).resolve().parents:
        print(f"benchmark: the program at {program.__file__} is not this checkout's",
              file=sys.stderr)
        return 3
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda")
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
