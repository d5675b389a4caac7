"""The port's copies of the JAX package's host modules have not drifted.

The port imports nothing of ``realtime_analytics_tpu``, so it keeps its own
copy of every host module it needs, with the package prefix rewritten. The
JAX package's host tests (test_tracker.py, test_bytetrack.py,
test_ingest.py, test_kafka_transport.py, test_pipeline_units.py,
test_dashboard.py, ...) run on the originals only; they hold the copies
through this file. Each copy is read beside its original, the original's
``realtime_analytics_tpu`` rewritten to ``realtime_analytics_tpu_torch``,
and the two must be equal. A file that differs by design is named below
with what it may differ in: its module docstring, and each named
replacement, which must occur exactly once. The dashboard's static assets
are compared byte for byte.

``config.py`` is not a copy: the port's config keeps the JAX schema but
decides its own device labels (``auto`` and ``cuda`` mean the card, ``tpu``
is refused), what the ``pallas_*`` knobs switch (the Hopper kernels) and
the ``s2d_backbone`` no-op, so it is held by tests/test_torch_engine.py and
the port's config tests instead.
"""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
JAX = REPO / "realtime_analytics_tpu"
PORT = REPO / "realtime_analytics_tpu_torch"

# directories whose every Python module is a copy
COPIED_DIRS = ("sinks", "telemetry", "eval", "api")
COPIED_FILES = (
    "tracker.py", "bytetrack.py", "types.py",
    "ingest/ffmpeg_simulator.py", "ingest/synthetic.py", "ingest/video_stream.py",
    "utils/__init__.py", "utils/frame_filter.py",
    "scripts/__init__.py", "scripts/check_encoding.py", "scripts/gen_streams.py",
    "scripts/logging_setup.py", "scripts/make_demo_video.py",
    "scripts/simulate_data.py",
)

# file -> replacements (in the rewritten original -> in the port's copy);
# the module docstring may differ in each of these files
BY_DESIGN = {
    "ingest/__init__.py": [],
    "engine/batcher.py": [  # the serving path's spans (telemetry/spans.py)
        ("from ..types import Detection, FramePacket\n",
         "from ..telemetry import spans\nfrom ..types import Detection, FramePacket\n"),
        ("        t0 = time.perf_counter()\n"
         "        try:\n"
         "            results = await asyncio.to_thread(self.engine.predict_packets, packets)\n",
         "        batch = spans.new_batch()\n"
         "        t0 = time.perf_counter()\n"
         "        try:\n"
         "            results = await asyncio.to_thread(\n"
         "                spans.run_batch, batch, self.engine.predict_packets, packets)\n"),
        ("            self.metrics.observe_batch(len(items), infer_ms / 1e3)\n"
         "        for fut, dets in zip(futures, results):\n",
         "            self.metrics.observe_batch(len(items), infer_ms / 1e3)\n"
         "        if batch is not None:\n"
         "            batch.carried(packets, submit_times)\n"
         "        for fut, dets in zip(futures, results):\n"),
    ],
    "ops/tiling.py": [],
    "native/__init__.py": [  # the build cache lives in the checkout
        ('Path.home() / ".cache" / "rva_native")',
         'Path(__file__).resolve().parents[2] / "build" / "native")'),
    ],
    "pipeline.py": [  # the temporal engine's name and its buffer read
        ("from .engine.temporal import JaxTemporalEngine",
         "from .engine.temporal import TorchTemporalEngine"),
        ("                if isinstance(self.detector, JaxTemporalEngine):",
         "                if isinstance(self.detector, TorchTemporalEngine):"),
        ("        if isinstance(self.detector, JaxTemporalEngine):\n"
         "            buf = self.detector._buffers.get(cfg.name)\n",
         "        if isinstance(self.detector, TorchTemporalEngine):\n"),
        ("                buffer_size=len(buf) if buf else 0,",
         "                buffer_size=self.detector.buffered(cfg.name),"),
        # the serving path's spans (telemetry/spans.py)
        ("from .telemetry.metrics import MetricsPublisher\n",
         "from .telemetry import spans\nfrom .telemetry.metrics import MetricsPublisher\n"),
        ("            return\n"
         "        await self._finish_packet(packet, t_start, detections)\n",
         "            return\n"
         "        with spans.completing(self.stream.name, packet.frame_id, t_start):\n"
         "            await self._finish_packet(packet, t_start, detections)\n"),
        ("        tracks = await self._tracker_update(detections)\n",
         "        with spans.span(\"tracker\"):\n"
         "            tracks = await self._tracker_update(detections)\n"),
        ("        await self.kafka.send_tracks(\n"
         "            cfg.name, packet.frame_id, tracks, packet.frame,\n"
         "            health=self.health.health_score, fps=self.health.effective_fps,\n"
         "        )\n",
         "        with spans.span(\"sink\"):\n"
         "            await self.kafka.send_tracks(\n"
         "                cfg.name, packet.frame_id, tracks, packet.frame,\n"
         "                health=self.health.health_score, fps=self.health.effective_fps,\n"
         "            )\n"),
    ],
    "scripts/run_dashboard.py": [  # the port's program name
        ('        prog="realtime-analytics-dashboard",',
         '        prog="realtime-analytics-torch-dashboard",'),
    ],
    "scripts/run_pipeline.py": [
        # the port's program name
        ('        prog="realtime-analytics",\n'
         '        description="TPU-native multi-stream realtime video analytics pipeline",\n',
         '        prog="realtime-analytics-torch",\n'
         '        description="Multi-stream realtime video analytics pipeline "\n'
         '                    "(PyTorch / CUDA)",\n'),
        ('"process per chip on a multi-chip host)",',
         '"process per card on a multi-card host)",'),
        # shard i pinned to card i through CUDA_VISIBLE_DEVICES
        ('        "--shard-device-env", choices=["none", "tpu"], default="none",\n'
         '        help="with --shards on a multi-chip TPU host: \'tpu\' pins shard i to "\n'
         '             "chip i via TPU_VISIBLE_DEVICES",\n',
         '        "--shard-device-env", choices=["none", "cuda"], default="none",\n'
         '        help="with --shards on a multi-card host: \'cuda\' pins shard i to "\n'
         '             "card i via CUDA_VISIBLE_DEVICES (\'none\': all shards share "\n'
         '             "the visible cards)",\n'),
        ('        if args.shard_device_env == "tpu":\n'
         '            env["TPU_VISIBLE_DEVICES"] = str(i)\n',
         '        if args.shard_device_env == "cuda":\n'
         '            env["CUDA_VISIBLE_DEVICES"] = str(i)\n'),
        # the profile flag: --torch-profile for --jax-profile
        ('        "--jax-profile", default=None, metavar="DIR",\n'
         '        help="capture a jax.profiler trace of the run into DIR",\n',
         '        "--torch-profile", default=None, metavar="DIR",\n'
         '        help="capture a torch.profiler trace of the run into DIR",\n'),
        ("a supervisor-only --log-file/--jax-profile captures nothing",
         "a supervisor-only --log-file/--torch-profile captures nothing"),
        ('        if getattr(args, "jax_profile", None):\n'
         '            c += ["--jax-profile", f"{args.jax_profile}/shard{i}"]\n',
         '        if args.torch_profile:\n'
         '            c += ["--torch-profile", f"{args.torch_profile}/shard{i}"]\n'),
        ("    from ..utils.profiling import jax_trace\n",
         "    from ..utils.profiling import torch_trace\n"),
        ("        with jax_trace(args.jax_profile):\n",
         "        with torch_trace(args.torch_profile):\n"),
        # no forced exit for XLA compile threads: the port has none
        ("        rc = asyncio.run(_amain(args))\n",
         "        return asyncio.run(_amain(args))\n"),
        ('        rc = 0\n'
         '    # An XLA compile in a worker thread cannot be cancelled; if one is still\n',
         '        return 0\n'
         '    # An XLA compile in a worker thread cannot be cancelled; if one is still\n'),
    ],
}
# file -> (start, end) of a span of the original that the port leaves out:
# the tail of JAX's main() that waits out XLA compile threads
CUT = {"scripts/run_pipeline.py": (
    "    # An XLA compile in a worker thread cannot be cancelled", "\n\nif __name__")}

C_COPIES = {
    "native/hostops.c": [
        (" * pick_u8: the host pixel-pick that feeds the TPU when",
         " * pick_u8: the host pixel-pick that feeds the device when"),
    ],
}


def _rewrite(text: str) -> str:
    return text.replace("realtime_analytics_tpu", "realtime_analytics_tpu_torch")


def _without_docstring(text: str) -> str:
    body = ast.parse(text).body
    if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        return "\n".join(text.splitlines()[body[0].end_lineno:]) + "\n"
    return text


def _apply(text: str, rel: str, replacements) -> str:
    for old, new in replacements:
        assert text.count(old) == 1, f"{rel}: {old!r} is no longer in the original once"
        text = text.replace(old, new)
    return text


def _copied_modules():
    names = set(COPIED_FILES)
    for d in COPIED_DIRS:
        names |= {str(p.relative_to(JAX)) for p in (JAX / d).glob("*.py")}
    return sorted(names)


@pytest.mark.parametrize("rel", _copied_modules())
def test_copy_equals_its_original(rel):
    port = PORT / rel
    assert port.is_file(), f"the port has no copy of {rel}"
    assert port.read_text() == _rewrite((JAX / rel).read_text()), (
        f"{rel} drifted from realtime_analytics_tpu/{rel}")


@pytest.mark.parametrize("rel", sorted(BY_DESIGN))
def test_copy_differs_only_by_design(rel):
    want = _rewrite((JAX / rel).read_text())
    want = _without_docstring(_apply(want, rel, BY_DESIGN[rel]))
    if rel in CUT:
        start, end = CUT[rel]
        at = want.index(start)
        want = want[:at] + want[want.index(end, at):]
    got = _without_docstring((PORT / rel).read_text())
    assert got == want, f"{rel} differs from its original beyond what is named"


@pytest.mark.parametrize("rel", sorted(C_COPIES))
def test_c_copy_differs_only_by_design(rel):
    want = _apply((JAX / rel).read_text(), rel, C_COPIES[rel])
    assert (PORT / rel).read_text() == want


def _static_files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def test_static_assets_are_the_same_files():
    assert _static_files(PORT / "api" / "static") == _static_files(JAX / "api" / "static")


@pytest.mark.parametrize("rel", _static_files(JAX / "api" / "static"))
def test_static_asset_is_byte_identical(rel):
    assert (PORT / "api" / "static" / rel).read_bytes() == \
        (JAX / "api" / "static" / rel).read_bytes()


def test_every_copied_directory_is_complete():
    """A module added to a copied directory of the JAX package needs its
    copy (or a place in BY_DESIGN) in the port."""
    for d in COPIED_DIRS + ("ingest",):
        jax_names = {p.name for p in (JAX / d).glob("*.py")}
        port_names = {p.name for p in (PORT / d).glob("*.py")}
        assert jax_names <= port_names, (d, sorted(jax_names - port_names))
