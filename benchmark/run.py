"""One run of one cell of the port's benchmark.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``realtime_analytics_tpu_torch``. The
run makes the cell's weights and frames from ``--seed``, builds the
program's serving path as the cell's traffic driver sets it up (the set-up,
timed as ``setup_s`` from the process's start), measures ``--seconds``
seconds of the traffic, then checks what the timed path served against the
plain fp32 reference (``reference/yolov8.py``) and prints one JSON line
last on standard output:

``{"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
"card", "checks"}``

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones, read from a ``torch.profiler`` trace of the window's last
seconds (``trace.py``) and from the program's counters. ``checks`` gives
each number compared with its limit; the same lines end standard error.

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
    """What a traffic driver is handed: the cell, the seed, the window's
    length, the device, the tracer, and the helpers that make the cell's
    inputs. The driver calls ``open_window`` when set-up is done and reports
    its readings in the dict it returns."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: str,
                 workdir: str):
        from .trace import SECONDS, Tracer

        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.seed, self.seconds, self.device, self.workdir = seed, seconds, device, workdir
        self.tracer = Tracer(trace)
        self.tracer_seconds = min(SECONDS, seconds)
        self.state_dict = None
        self.t_open = self.t_open_wall = None

    def checkpoint(self) -> str:
        """The cell's seeded checkpoint, written to the work directory; its
        fp32 tensors stay on the host for the reference."""
        from .weights import seeded_state_dict, write_checkpoint

        sd = seeded_state_dict(self.config["scale"], self.seed, self.device)
        self.state_dict = {k: v.cpu() for k, v in sd.items()}
        return write_checkpoint(self.state_dict, self.workdir, self.config["scale"], self.seed)

    def detector_config(self, model_path: str, buckets, warmup: bool):
        from realtime_analytics_tpu_torch.config import DetectorConfig

        c = self.config
        return DetectorConfig(
            model_path=model_path, model_type="yolov8", device=self.device,
            confidence_threshold=c["confidence_threshold"], iou_threshold=c["iou_threshold"],
            input_size=[c["input_size"], c["input_size"]], num_classes=c["nc"],
            max_batch_size=max(buckets), batch_buckets=sorted(buckets),
            max_detections=c["max_detections"], pre_nms_topk=c["pre_nms_topk"],
            precision=c["precision"], warmup=warmup)

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


def check(config: Dict, state_dict, samples, device: str) -> Dict:
    """Each compared number's reading over the sampled frames, beside its
    limit. ``samples``: (key, frame uint8 [H, W, 3], boxes, scores, classes);
    the reference runs once over each distinct key, in blocks."""
    import numpy as np
    import torch

    from . import compare
    from .reference.yolov8 import YoloV8, run as reference_run

    by_key: Dict = {}
    for s in samples:
        by_key.setdefault(s[0], []).append(s)
    keys = list(by_key)
    counts: List[Dict[str, int]] = []
    model = YoloV8(state_dict, device) if keys else None
    for lo in range(0, len(keys), 8):
        block = keys[lo:lo + 8]
        frames = torch.from_numpy(np.stack([by_key[k][0][1] for k in block]))
        anchors, dets = reference_run(
            model, frames, config["confidence_threshold"], config["iou_threshold"],
            config["pre_nms_topk"], config["max_detections"], config["input_size"])
        for k, a, d in zip(block, anchors, dets):
            for _, _, boxes, scores, classes in by_key[k]:
                counts.append(compare.frame_counts(a, d, boxes, scores, classes))
    readings = compare.shares(counts)
    out = {name: {"value": readings.get(name), "limit": limit}
           for name, limit in config["limits"].items()}
    out["frames"] = {"value": len(counts), "limit": 1}
    return out


def passes(checks: Dict) -> bool:
    ok = checks["frames"]["value"] >= checks["frames"]["limit"]
    return ok and all(c["value"] is None or c["value"] <= c["limit"]
                      for k, c in checks.items() if k != "frames")


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
        state_dict, summary = ctx.state_dict, ctx.tracer.summary
        samples = readings.pop("samples")
        del ctx
        gc.collect()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        if cuda:
            torch.cuda.empty_cache()
        checks = check(cell.config, state_dict, samples, device)
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
    result = {"correct": passes(checks), "attempted": int(readings["attempted"]),
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
