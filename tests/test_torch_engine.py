"""The port's detection engine against ``JaxYoloEngine`` on the CPU.

Both engines load the same He-scaled Ultralytics-layout weights
(scripts/gen_golden_fixture.py ``synthetic_weights``) from one flat .npz
and see the same 384x384 crops of the committed golden scene — an exact 3x
pixel pick at 128 input, i.e. the selected step with the stem fold. The JAX
side runs its Pallas kernels in interpret mode (pallas_gather / decode on,
pallas_stem interpret); the port runs the kernels' plain versions (its CPU
form). Bounds: num_valid and classes equal, boxes atol 1e-2 px, scores atol
1e-4; the 0.25 threshold leaves a dozen or more well-separated detections
per frame.
"""

import importlib.util
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.engine.detector import JaxYoloEngine
from realtime_analytics_tpu_torch.config import ConfigError, DetectorConfig
from realtime_analytics_tpu_torch.engine.detector import (
    TorchYoloEngine,
    create_detector,
)

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "gen_golden_fixture", os.path.join(REPO, "scripts", "gen_golden_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    path = tmp_path_factory.mktemp("w") / "yolov8n_synthetic.npz"
    np.savez(path, **fixture.synthetic_weights())
    return str(path)


@pytest.fixture(scope="module")
def frames():
    scene = cv2.imread(os.path.join(REPO, "tests", "data", "golden_scene.png"))
    return np.stack([scene[y:y + 384, x:x + 384]
                     for y, x in ((300, 100), (500, 700), (600, 1200), (200, 1500))])


def _kw(path, **over):
    kw = dict(model_path=path, device="cpu", confidence_threshold=0.25,
              warmup=False, input_size=[128, 128], max_batch_size=4,
              batch_buckets=[4], pre_nms_topk=256, precision="fp32")
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def torch_engine(weights_npz):
    return TorchYoloEngine(DetectorConfig(**_kw(weights_npz)))


def test_engine_matches_jax_selected_step(weights_npz, frames, torch_engine):
    jax_engine = JaxYoloEngine(JaxConfig(**_kw(
        weights_npz, pallas_gather="on", pallas_decode="on",
        pallas_stem="interpret")))
    assert jax_engine.model.pallas_decode == "interpret"
    assert jax_engine._nms_gather_impl() == "pallas_interpret"
    want = jax_engine.predict_arrays(frames)
    _, selected = torch_engine.host_prepare(frames, frames.shape[1:3])
    assert selected  # the stem-folded selected step
    got = torch_engine.predict_arrays(frames)
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    assert want.num_valid.min() >= 10
    for i, n in enumerate(want.num_valid):
        np.testing.assert_array_equal(got.class_ids[i, :n], want.class_ids[i, :n])
        np.testing.assert_allclose(got.boxes_xyxy[i, :n], want.boxes_xyxy[i, :n],
                                   atol=1e-2)
        np.testing.assert_allclose(got.scores[i, :n], want.scores[i, :n], atol=1e-4)
    for field in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        assert getattr(got, field).dtype == getattr(want, field).dtype
        assert getattr(got, field).shape == getattr(want, field).shape


def test_kernel_knobs_off_give_the_same_detections(weights_npz, frames, torch_engine):
    """pallas_* off = the plain layer-by-layer path; on the CPU the kernel
    wrappers take the kernels' plain versions, which agree with it."""
    off = TorchYoloEngine(DetectorConfig(**_kw(
        weights_npz, pallas_gather="off", pallas_decode="off", pallas_stem="off")))
    assert (off.model.pallas_stem, off.model.pallas_decode, off._nms_gather) == (
        "off", "off", "torch")
    assert (torch_engine.model.pallas_stem, torch_engine.model.pallas_decode,
            torch_engine._nms_gather) == ("on", "on", "kernel")
    a, b = off.predict_arrays(frames), torch_engine.predict_arrays(frames)
    np.testing.assert_array_equal(a.num_valid, b.num_valid)
    np.testing.assert_array_equal(a.class_ids, b.class_ids)
    np.testing.assert_allclose(a.boxes_xyxy, b.boxes_xyxy, atol=1e-2)


def test_device_resize_step_and_bucket_padding(torch_engine, frames):
    """A fractional geometry on the CPU takes the plain device letterbox
    (host_resize auto is off on the CPU); a batch of 3 pads to bucket 4."""
    assert not torch_engine._host_resize_active()
    small = np.ascontiguousarray(frames[:3, :300, :250])
    prepared, selected = torch_engine.host_prepare(small, small.shape[1:3])
    assert not selected and prepared is small
    res = torch_engine.predict_arrays(small)
    assert res.boxes_xyxy.shape == (3, 300, 4)
    n = res.num_valid
    for i in range(3):
        bx = res.boxes_xyxy[i, :n[i]]
        assert np.all(bx[:, [0, 2]] <= 249) and np.all(bx[:, [1, 3]] <= 299)


def test_concurrent_predicts_match_serial(torch_engine, frames):
    """The batcher calls predict_packets from several threads at once: the
    engine shares only read-only weights, so results match serial ones."""
    want = torch_engine.predict_arrays(frames).scores
    results, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            try:
                for _ in range(3):
                    results.append(torch_engine.predict_arrays(frames).scores)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(results) == 12
    for r in results:
        np.testing.assert_array_equal(r, want)


def test_warmup_records_bucket_costs(torch_engine):
    torch_engine.warmup((384, 384))
    costs = torch_engine._bucket_cost_ms[(384, 384)]
    assert set(costs) == {4} and costs[4] > 0


def test_device_rules():
    with pytest.raises(ConfigError):
        DetectorConfig(device="tpu").validate()
    for dev in ("auto", "cuda", "cuda:0", "cpu", "CUDA:1"):
        DetectorConfig(device=dev).validate()
    if not torch.cuda.is_available():
        # no card: auto/cuda RAISE, they never drop to the CPU
        for dev in ("auto", "cuda", "cuda:0"):
            with pytest.raises(RuntimeError, match="device: cpu"):
                TorchYoloEngine(DetectorConfig(model_path="__random__.pt",
                                               device=dev, warmup=False))


@pytest.mark.parametrize("over", [
    dict(model_type="resnet", model_path="resnet18-seeded.pt", input_size=[64, 64]),
    dict(model_type="cnn_lstm", input_size=[64, 64], sequence_length=2),
    dict(input_size=[64, 64]),
], ids=["resnet", "temporal", "yolo"])
def test_mesh_routes_serve(over):
    """``detector.mesh_shape`` builds each engine family over a CPU mesh
    (dp x tp entries of the CPU) and serves a batch rounded up to dp; the
    engines against one device are in tests/test_torch_parallel.py."""
    from realtime_analytics_tpu_torch.config import StreamConfig
    from realtime_analytics_tpu_torch.types import FramePacket

    cfg = DetectorConfig(**{**dict(device="cpu", warmup=False, model_path="__random__.pt",
                                   max_batch_size=4, batch_buckets=[1, 4],
                                   mesh_shape=[2, 2]), **over})
    eng = create_detector(cfg)
    assert eng.mesh is not None and eng.mesh.shape == {"dp": 2, "tp": 2}
    assert eng._round_mesh(1) == 2
    frame = np.random.default_rng(0).integers(0, 256, (96, 128, 3), dtype=np.uint8)
    packets = [FramePacket(stream=StreamConfig(name="cam", url="synthetic://"), frame=frame,
                           frame_id=i, timestamp=0.0) for i in range(4)]
    out = eng.predict_packets(packets)
    assert len(out) == 4


def test_s2d_knob_is_a_logged_noop(weights_npz, frames, monkeypatch):
    """``s2d_backbone: on`` runs the s2d prefix (nodes 0-3, its weights
    scattered once) in place of B3, with the detections of the plain path;
    ``auto`` is a no-op off the TPU (the JAX engine's policy): B3 runs."""
    from realtime_analytics_tpu_torch.models import yolo

    calls = []
    stem, prefix = yolo.fused_stem_p1p2, yolo.YoloModel._apply_s2d_prefix
    monkeypatch.setattr(yolo, "fused_stem_p1p2", lambda *a: calls.append("B3") or stem(*a))
    monkeypatch.setattr(yolo.YoloModel, "_apply_s2d_prefix",
                        lambda *a: calls.append("s2d") or prefix(*a))
    on = TorchYoloEngine(DetectorConfig(**_kw(weights_npz, s2d_backbone="on")))
    auto = TorchYoloEngine(DetectorConfig(**_kw(weights_npz, s2d_backbone="auto")))
    assert on.model.pallas_stem == auto.model.pallas_stem == "on"
    assert on._s2d_for_bucket(4) and not auto._s2d_for_bucket(4)
    assert on.model.s2d_prep is not None and auto.model.s2d_prep is None
    got = on.predict_arrays(frames)
    assert calls == ["s2d"]
    want = auto.predict_arrays(frames)
    assert calls == ["s2d", "B3"]
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    np.testing.assert_array_equal(got.class_ids, want.class_ids)
    np.testing.assert_allclose(got.boxes_xyxy, want.boxes_xyxy, atol=1e-2)
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4)


def test_profile_step_needs_a_card(capsys):
    """The step profiler measures the card only: without one it fails and
    prints no result."""
    from realtime_analytics_tpu_torch.scripts import profile_step

    assert profile_step._merged_span([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4
    if not torch.cuda.is_available():
        assert profile_step.main(["--batch", "1"]) == 1
        assert capsys.readouterr().out == ""


def test_seeded_random_init_is_deterministic():
    cfg = dict(model_path="__random__.pt", device="cpu", warmup=False,
               input_size=[64, 64], max_batch_size=1, precision="fp32")
    a, b = TorchYoloEngine(DetectorConfig(**cfg)), TorchYoloEngine(DetectorConfig(**cfg))
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
    t0 = time.perf_counter()
    a.predict_arrays(np.zeros((1, 64, 64, 3), np.uint8))
    assert a.last_infer_ms > 0 and time.perf_counter() - t0 < 60
