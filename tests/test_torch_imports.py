"""The port imports neither JAX, optax nor the JAX package.

The runtime check runs in a subprocess: this test process already has JAX
loaded (tests/conftest.py imports it first). The AST scan covers import
statements the runtime check might not reach (function-local imports).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "realtime_analytics_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_every_port_module_imports_without_jax():
    code = """
import importlib, pkgutil, sys
import realtime_analytics_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "jaxlib"
             or m == "optax" or m.startswith("optax.")
             or m == "realtime_analytics_tpu" or m.startswith("realtime_analytics_tpu."))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 30, names
assert {"realtime_analytics_tpu_torch.ops.int8",
        "realtime_analytics_tpu_torch.ops.tiling",
        "realtime_analytics_tpu_torch.models.onnx_lite",
        "realtime_analytics_tpu_torch.models.onnx_exec",
        "realtime_analytics_tpu_torch.models.onnx_torch",
        "realtime_analytics_tpu_torch.models.onnx_graph_model",
        "realtime_analytics_tpu_torch.models.onnx_export",
        "realtime_analytics_tpu_torch.models.quantize",
        "realtime_analytics_tpu_torch.engine.export",
        "realtime_analytics_tpu_torch.engine.graphs",
        "realtime_analytics_tpu_torch.scripts.export_engine",
        "realtime_analytics_tpu_torch.scripts.quantize_model",
        "realtime_analytics_tpu_torch.scripts.export_temporal_model",
        "realtime_analytics_tpu_torch.parallel.train",
        "realtime_analytics_tpu_torch.parallel.mesh",
        "realtime_analytics_tpu_torch.parallel.dryrun",
        "realtime_analytics_tpu_torch.eval.detection_metrics",
        "realtime_analytics_tpu_torch.utils.profiling",
        "realtime_analytics_tpu_torch.scripts.train",
        "realtime_analytics_tpu_torch.scripts.eval_detections",
        "realtime_analytics_tpu_torch.scripts.gen_streams",
        "realtime_analytics_tpu_torch.scripts.check_encoding",
        "realtime_analytics_tpu_torch.scripts.simulate_data",
        "realtime_analytics_tpu_torch.scripts.make_demo_video",
        "realtime_analytics_tpu_torch.scripts.test_temporal_detector",
        "realtime_analytics_tpu_torch.api",
        "realtime_analytics_tpu_torch.api.schemas",
        "realtime_analytics_tpu_torch.api.state",
        "realtime_analytics_tpu_torch.api.consumer",
        "realtime_analytics_tpu_torch.api.server",
        "realtime_analytics_tpu_torch.scripts.run_dashboard",
        "realtime_analytics_tpu_torch.scripts.run_pipeline",
        "realtime_analytics_tpu_torch.scripts.gen_yolo_manifest",
        "realtime_analytics_tpu_torch.scripts.bench",
        "realtime_analytics_tpu_torch.scripts.bench_graph_path",
        "realtime_analytics_tpu_torch.scripts.bench_early_layers"} <= set(names), names
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_names(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_jax_import_statement_anywhere_in_the_port():
    assert len(SOURCES) > 30
    assert {PKG / "api" / "server.py", PKG / "scripts" / "run_dashboard.py",
            REPO / "chip_smoke.py"} <= set(SOURCES)
    offenders = []
    for path in SOURCES:
        for name in _imported_names(path):
            root = name.split(".")[0]
            # the root bench.py and scripts/ import JAX: the port keeps its own copies
            if root in ("jax", "jaxlib", "optax", "bench", "scripts") \
                    or root == "realtime_analytics_tpu":
                offenders.append(f"{path.relative_to(REPO)}: {name}")
    assert not offenders, offenders
