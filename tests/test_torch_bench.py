"""The port's benchmark entry points (``realtime_analytics_tpu_torch/scripts/
bench.py``, ``bench_graph_path.py``, ``bench_early_layers.py`` and the copy
of ``gen_yolo_manifest.py``) on the CPU, against the JAX package where the
two compute the same thing.

* the bench under ``--device cpu`` at two small buckets and a 2 s pipeline
  window prints one parseable last line with the JAX summary's keys plus
  ``e2e_p99_ms`` and ``card``, and writes its capture with no error;
* without a card (and without ``--device cpu``) every entry point exits
  non-zero before any work, and the bench writes no capture;
* the FLOPs the bench counts for one 640^2 image are within 3% of XLA's
  cost analysis of the JAX step over one 1080p frame;
* the manifest copy has not drifted from the root script; the seeded
  checkpoint it gives is consumed key by key by the port's loader and
  loads to the JAX loader's params exactly;
* the bench's selected step (fp32) equals the JAX ``_build_step_selected``
  on the same frames, at tests/test_torch_engine.py's tolerances;
* section 4's graph, written with ``onnx_lite``, served by the graph
  engine, equals the seeded torch module (rtol and atol 1e-5, fp32);
* the differential's arithmetic, on an injected clock, and the profiler
  window's, on stubbed events.
"""

import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.engine.detector import JaxYoloEngine
from realtime_analytics_tpu.models.weights import load_yolo_checkpoint as jax_load
from realtime_analytics_tpu.models.yolo import build_yolo as jax_build_yolo
from realtime_analytics_tpu_torch.models.weights import (
    load_yolo_checkpoint,
    yolo_params_from_state_dict,
)
from realtime_analytics_tpu_torch.models.yolo import build_yolo
from realtime_analytics_tpu_torch.scripts import (
    bench,
    bench_early_layers,
    bench_graph_path,
    gen_yolo_manifest,
)

REPO = Path(__file__).resolve().parents[1]
# the root bench.py's summary keys (bench.py:1002-1013)
JAX_SUMMARY_KEYS = ("metric", "value", "unit", "vs_baseline", "p50_batch_ms",
                    "device_batch", "mfu", "weights", "platform", "e2e_steady_fps",
                    "e2e_p50_ms", "e2e_startup_s", "e2e_slo", "capture")
# keys a loader does not read: BN bookkeeping, the fixed DFL projection
IGNORABLE = re.compile(r"(\.num_batches_tracked$|\.dfl\.conv\.weight$)")


def _root_manifest_module():
    spec = importlib.util.spec_from_file_location(
        "root_gen_yolo_manifest", REPO / "scripts" / "gen_yolo_manifest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def manifest_npz(tmp_path_factory):
    return bench.manifest_checkpoint(str(tmp_path_factory.mktemp("w") / "yolov8n.npz"))


def test_bench_cpu_run_prints_one_parseable_line(tmp_path):
    capture = tmp_path / "capture.json"
    env = {k: v for k, v in os.environ.items() if not k.startswith("RVA_BENCH_")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="2", RVA_BENCH_BATCHES="1,2",
               RVA_BENCH_STREAMS="2", RVA_BENCH_PIPELINE_SECONDS="2",
               RVA_BENCH_REAL_SECONDS="2", RVA_BENCH_TEMPORAL="0", RVA_BENCH_RESNET="0",
               RVA_BENCH_GRAPH="0", RVA_BENCH_CAPTURE=str(capture))
    proc = subprocess.run(
        [sys.executable, "-m", "realtime_analytics_tpu_torch.scripts.bench", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(JAX_SUMMARY_KEYS) | {"e2e_p99_ms", "card"} <= set(line), line
    assert line["platform"] == "cpu" and line["mfu"] is None and line["card"] is None
    assert line["weights"] == "manifest-synthetic"
    assert line["device_batch"] in (1, 2) and line["value"] > 0
    assert line["e2e_p99_ms"] >= line["e2e_p50_ms"] > 0
    full = json.loads(capture.read_text())
    assert not bench.has_error(full)
    assert [r["device_batch"] for r in full["all_batches"]] == [1, 2]
    # method B at the last bucket; no device metric on the CPU
    assert "batch_ms_alt" in full["all_batches"][1]
    assert all("device_busy_ms" not in r for r in full["all_batches"])
    assert full["pipeline_e2e"]["n_streams"] == 2
    assert full["pipeline_e2e"]["frames_processed"] > 0
    assert full["real_engine_window"] == full["temporal"] == full["graph_onnx"] == {}
    assert full["model_gflops_per_batch"] > 0


@pytest.mark.parametrize("module", [bench, bench_graph_path, bench_early_layers],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_points_exit_nonzero_without_a_card(module, tmp_path, monkeypatch, capsys):
    capture = tmp_path / "capture.json"
    monkeypatch.setenv("RVA_BENCH_CAPTURE", str(capture))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    assert module.main([]) != 0
    assert "no CUDA card visible" in capsys.readouterr().err
    assert not capture.exists() and list(tmp_path.iterdir()) == []


def test_flops_per_image_match_xla_cost_analysis():
    engine = bench.build_engine("missing-yolov8n.pt", (1,), "cpu")
    port = bench.flops_per_image(engine)
    jax_engine = JaxYoloEngine(JaxConfig(
        model_path="missing-yolov8n.pt", model_type="yolov8", confidence_threshold=0.25,
        iou_threshold=0.45, input_size=[640, 640], max_batch_size=1, batch_buckets=[1],
        max_detections=300, pre_nms_topk=512, precision="bf16", warmup=False,
        compile_cache_dir=None))
    host, selected = jax_engine.host_prepare(np.zeros((1, *bench.SRC_HW, 3), np.uint8),
                                             bench.SRC_HW)
    assert selected
    step = jax_engine._build_step_selected(bench.SRC_HW, 1)
    ca = step.lower(jax_engine.params, jax.device_put(host)).compile().cost_analysis()
    if isinstance(ca, (list, tuple)):
        ca = ca[0]
    xla = float(ca["flops"])
    print(f"FLOPs of one 640^2 image: port {port:.6g} (FlopCounterMode), XLA {xla:.6g}")
    assert abs(port / xla - 1.0) < 0.03


@pytest.mark.parametrize("size", ["n", "s"])
@pytest.mark.parametrize("family", ["yolov8_manifest", "yolov5_manifest"])
def test_manifest_copy_matches_the_root_script(family, size):
    root = _root_manifest_module()
    assert getattr(gen_yolo_manifest, family)(size) == getattr(root, family)(size)


def test_manifest_checkpoint_loads_as_in_jax(manifest_npz):
    class TrackingDict(dict):
        accessed: set

        def __getitem__(self, key):
            self.accessed.add(key)
            return super().__getitem__(key)

    sd = TrackingDict(np.load(manifest_npz))
    sd.accessed = set()
    assert set(sd) == set(gen_yolo_manifest.yolov8_manifest("n"))
    yolo_params_from_state_dict(build_yolo("yolov8", "n", 80), sd, prefix="model.")
    unread = {k for k in sd if k not in sd.accessed and not IGNORABLE.search(k)}
    assert not unread, sorted(unread)[:10]

    port = load_yolo_checkpoint(build_yolo("yolov8", "n", 80), manifest_npz)
    want = jax_load(jax_build_yolo("yolov8", "n", 80), manifest_npz)
    got_leaves = jax.tree_util.tree_leaves_with_path(port)
    want_leaves = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (path, a), (_, b) in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=str(path))


def test_bench_selected_step_matches_jax(manifest_npz):
    """fp32, manifest weights, 2 x 1080p: the seeded checkpoint's BN gammas
    are small, so the scores are nearly one value; both packages still pick
    the same boxes in the same order."""
    import cv2

    scene = cv2.imread(str(REPO / "tests" / "data" / "golden_scene.png"))
    frames = np.ascontiguousarray(np.stack([scene, scene[::-1, ::-1]]))
    engine = bench.build_engine(manifest_npz, (2,), "cpu", precision="fp32")
    step, selected = bench.production_step(engine)
    assert selected
    host, _ = engine.host_prepare(frames, bench.SRC_HW)
    with torch.inference_mode():
        boxes, scores, classes, num_valid = (t.numpy() for t in step(torch.from_numpy(host)))
    jax_engine = JaxYoloEngine(JaxConfig(
        model_path=manifest_npz, model_type="yolov8", confidence_threshold=0.25,
        iou_threshold=0.45, input_size=[640, 640], max_batch_size=2, batch_buckets=[2],
        max_detections=300, pre_nms_topk=512, precision="fp32", warmup=False,
        compile_cache_dir=None, pallas_gather="on", pallas_decode="on",
        pallas_stem="interpret"))
    want = [np.asarray(a) for a in
            jax_engine._build_step_selected(bench.SRC_HW, 2)(jax_engine.params, host)]
    np.testing.assert_array_equal(num_valid, want[3])
    assert want[3].min() >= 10
    for i, n in enumerate(want[3]):
        np.testing.assert_array_equal(classes[i, :n], want[2][i, :n])
        np.testing.assert_allclose(boxes[i, :n], want[0][i, :n], atol=1e-2)
        np.testing.assert_allclose(scores[i, :n], want[1][i, :n], atol=1e-4)


def test_section4_graph_matches_the_torch_module(tmp_path):
    torch.manual_seed(0)
    module = bench.ForeignDet(256).eval()
    path = str(tmp_path / "fdet.onnx")
    bench.foreign_det_to_onnx(module, path)
    engine = bench.graph_engine(path, 256, 2, "cpu", "fp32")
    assert engine._graph_backed
    frames = np.random.default_rng(0).integers(0, 256, (2, 256, 256, 3), dtype=np.uint8)
    x = torch.from_numpy(frames[..., ::-1].astype(np.float32) / 255.0).permute(0, 3, 1, 2)
    with torch.inference_mode():
        got = engine.model.run(engine.model.params(), x.contiguous())[0]
        want = module(x)
    assert got.shape == want.shape == (2, 12, 256)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_section4_serves_every_format(tmp_path):
    rows = bench.bench_graph_onnx("cpu", str(tmp_path), side=64, batch=2)
    assert not bench.has_error(rows), rows
    for label in ("fp32", "bf16", "int8_qoperator", "qdq_int8_weights_bf16"):
        assert {"batch_ms", "frames_per_s", "seq_ms_per_batch"} <= set(rows[label])
        assert rows[label]["seq_ms_per_batch"] > 0
    assert rows["model"] == "foreign 6-conv detector @ 64, b=2"


def test_differential_arithmetic_on_an_injected_clock():
    class Clock:
        now = 0.0

        def __call__(self):
            return self.now

    clock = Clock()
    calls = []

    def run(k):  # 4 ms of dispatch, 2 ms a call; the first run of each length is 10 ms slower
        calls.append(k)
        clock.now += 0.004 + 0.002 * k + (0.010 if calls.count(k) == 1 else 0.0)
        return 0.0

    batch_ms, seq_ms = bench.differential(run, 21, clock)
    assert calls == [1, 21] + [1] * 3 + [21] * 3
    assert batch_ms == pytest.approx(2.0) and seq_ms == pytest.approx(6.0)
    durations = iter([0.030, 0.010, 0.020])

    def jittery(k):
        clock.now += next(durations)

    assert bench.best_of(jittery, 5, clock) == pytest.approx(0.010)


def test_k_call_runner_perturbs_and_consumes_every_output():
    x = torch.zeros((2, 3, 4, 3), dtype=torch.uint8)
    seen = []

    def step(t):
        seen.append(int(t[0, 0, 0, 0]))
        return t.float().sum(), torch.tensor([1, 2], dtype=torch.int32)

    total = bench.k_call_runner(step, x)(300)
    assert seen == [i % 251 for i in range(300)]
    assert total == sum(i % 251 for i in range(300)) + 3 * 300


def test_device_window_merges_busy_time_and_counts_waits(monkeypatch):
    """The profiler window's arithmetic on stubbed events (the CPU has no
    CUDA activity to trace): overlapping kernels merge, waits count by
    name, both per step."""
    from types import SimpleNamespace

    import torch.profiler
    from torch.autograd import DeviceType

    def event(name, kind, start, end):
        return SimpleNamespace(name=name, device_type=kind,
                               time_range=SimpleNamespace(start=start, end=end))

    events = [event("k0", DeviceType.CUDA, 0, 10), event("k1", DeviceType.CUDA, 5, 20),
              event("k2", DeviceType.CUDA, 30, 35),
              event("cudaMemcpyAsync", DeviceType.CPU, 0, 1),
              event("cudaStreamSynchronize", DeviceType.CPU, 1, 2),
              event("cudaStreamSynchronize", DeviceType.CPU, 3, 4),
              event("aten::add", DeviceType.CPU, 0, 50)]

    class Profile:
        def __init__(self, **_):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *_):
            return False

        def events(self):
            return events

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    steps = []
    row = bench.device_window(steps.append, steps=2)
    assert steps == [2]
    assert row["device_busy_ms"] == pytest.approx(25 / 1e3 / 2)
    assert row["idle_share"] == pytest.approx(0.5)
    assert row["kernels_per_step"] == 1.5 and row["host_waits_per_step"] == 1.5
    assert row["host_waits_by_call"] == {"cudaMemcpyAsync": 0.5, "cudaStreamSynchronize": 1.0}


def test_step_sync_sites_name_the_lines_torch_flags(monkeypatch):
    modes = []
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)

    def step(x):
        import warnings

        warnings.warn("called a synchronizing CUDA operation")  # flagged
        warnings.warn("Synchronization debug mode does not detect all synchronizing ops")
        return x

    sites = bench.step_sync_sites(step, torch.zeros(1))
    line = step.__code__.co_firstlineno + 3
    assert sites == {f"tests/test_torch_bench.py:{line}": 1}
    assert modes == ["warn", 0]


def test_settings_keep_the_jax_defaults():
    s = bench.Settings.from_env({})
    assert s.batches == (4, 16, 32, 64, 128) and s.crosscheck == (16, 128)
    assert (s.pipeline_seconds, s.real_seconds, s.streams) == (45.0, 15.0, 32)
    assert s.temporal and s.resnet and s.graph
    assert s.capture == os.path.join("build", "bench_torch_capture.json")
    s = bench.Settings.from_env({"RVA_BENCH_BATCHES": "8,32", "RVA_BENCH_GRAPH": "0"})
    assert s.batches == (8, 32) and s.crosscheck == (32,) and not s.graph
    assert bench.has_error({"a": [{"b": {"error": "x"}}]}) and not bench.has_error({"a": [1]})
