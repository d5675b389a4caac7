"""The port's exported engines against the JAX package's, on the CPU.

Both packages export the same weights through their own exporters
(``realtime_analytics_tpu/engine/export.py``: ``jax.export`` programs;
``realtime_analytics_tpu_torch/engine/export.py``: ``torch.export``
programs) and serve the same frames from their artifacts. The bounds are
those the live engines are held to: YOLO as tests/test_torch_engine.py
(num_valid and classes equal, boxes atol 1e-2 px, scores atol 1e-4; the
He-scaled golden weights on 384x384 crops of the golden scene, an exact 3x
pick at 128 input), ResNet as tests/test_torch_resnet.py (top-k classes
equal, softmax scores atol 1e-5) and the temporal clip step as
tests/test_torch_temporal.py (top-5 classes equal, softmax atol 1e-5). The
JAX engines run as the JAX package's own export tests run them on the CPU
(its kernels' XLA forms).

A JAX-made artifact is refused by the port with an error that names it.
The exported YOLO engines key their steps alike.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.config import StreamConfig as JaxStream
from realtime_analytics_tpu.engine.detector import JaxResNetEngine, JaxYoloEngine
from realtime_analytics_tpu.engine.export import (
    ExportedResNetEngine as JaxExportedResNet,
)
from realtime_analytics_tpu.engine.export import (
    ExportedTemporalEngine as JaxExportedTemporal,
)
from realtime_analytics_tpu.engine.export import ExportedYoloEngine as JaxExportedYolo
from realtime_analytics_tpu.engine.export import (
    export_serving_artifact as jax_export_serving_artifact,
)
from realtime_analytics_tpu.engine.temporal import JaxTemporalEngine
from realtime_analytics_tpu.models.resnet import build_resnet as jax_build_resnet
from realtime_analytics_tpu.models.temporal import build_temporal as jax_build_temporal
from realtime_analytics_tpu.types import FramePacket as JaxPacket
from realtime_analytics_tpu_torch.config import ConfigError, DetectorConfig, StreamConfig
from realtime_analytics_tpu_torch.engine.detector import (
    TorchResNetEngine,
    TorchYoloEngine,
    create_detector,
)
from realtime_analytics_tpu_torch.engine.export import (
    ExportedResNetEngine,
    ExportedTemporalEngine,
    ExportedYoloEngine,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
from realtime_analytics_tpu_torch.types import FramePacket

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def yolo_artifacts(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "gen_golden_fixture", os.path.join(REPO, "scripts", "gen_golden_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    tmp = tmp_path_factory.mktemp("yolo")
    weights = str(tmp / "yolov8n_synthetic.npz")
    np.savez(weights, **fixture.synthetic_weights())
    kw = dict(model_path=weights, device="cpu", confidence_threshold=0.25, warmup=False,
              input_size=[128, 128], max_batch_size=4, batch_buckets=[4],
              pre_nms_topk=256, precision="fp32")
    jax_path, torch_path = str(tmp / "jax.rvae"), str(tmp / "torch.rvae")
    jax_export_serving_artifact(JaxYoloEngine(JaxConfig(**kw)), jax_path, [(384, 384)])
    export_serving_artifact(TorchYoloEngine(DetectorConfig(**kw)), torch_path, [(384, 384)])
    return kw, jax_path, torch_path


def test_exported_yolo_matches_the_jax_exported_engine(yolo_artifacts):
    kw, jax_path, torch_path = yolo_artifacts
    want_eng = JaxExportedYolo(JaxConfig(**{**kw, "model_path": jax_path}))
    got_eng = create_detector(DetectorConfig(**{**kw, "model_path": torch_path}))
    assert isinstance(got_eng, ExportedYoloEngine)
    scene = cv2.imread(os.path.join(REPO, "tests", "data", "golden_scene.png"))
    frames = np.stack([scene[y:y + 384, x:x + 384]
                       for y, x in ((300, 100), (500, 700), (600, 1200), (200, 1500))])
    want, got = want_eng.predict_arrays(frames), got_eng.predict_arrays(frames)
    np.testing.assert_array_equal(got.num_valid, want.num_valid)
    assert want.num_valid.min() >= 10
    for i, n in enumerate(want.num_valid):
        np.testing.assert_array_equal(got.class_ids[i, :n], want.class_ids[i, :n])
        np.testing.assert_allclose(got.boxes_xyxy[i, :n], want.boxes_xyxy[i, :n], atol=1e-2,
                                   rtol=0)
        np.testing.assert_allclose(got.scores[i, :n], want.scores[i, :n], atol=1e-4, rtol=0)


def test_exported_yolo_steps_are_keyed_as_the_jax_exported_engine(yolo_artifacts):
    """Both exported engines cache their runnable steps in ``_steps``
    under the live engines' keys after the same warmup; the port keeps its
    loaded programs apart, by name."""
    kw, jax_path, torch_path = yolo_artifacts
    want_eng = JaxExportedYolo(JaxConfig(**{**kw, "model_path": jax_path}))
    got_eng = create_detector(DetectorConfig(**{**kw, "model_path": torch_path}))
    want_eng.warmup((384, 384))
    got_eng.warmup((384, 384))
    assert set(got_eng._steps) == set(want_eng._steps) == {(4, 384, 384, "sel")}
    assert set(got_eng._loaded_programs) == {"384x384_b4_sel"}


def test_a_jax_made_artifact_is_refused_by_name(yolo_artifacts):
    kw, jax_path, _ = yolo_artifacts
    with pytest.raises(ConfigError, match="JAX-made .rvae") as ei:
        create_detector(DetectorConfig(**{**kw, "model_path": jax_path}))
    assert "jax.export" in str(ei.value) and "realtime-analytics-torch-export" in str(ei.value)


def _packets(frames, jax_side):
    stream = (JaxStream if jax_side else StreamConfig)(name="cam", url="x")
    packet = JaxPacket if jax_side else FramePacket
    return [packet(stream=stream, frame=f, frame_id=i, timestamp=0.0)
            for i, f in enumerate(frames)]


def _smooth(h, w, seed):
    small = np.random.default_rng(seed).integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize("host_resize", ["on", "off"])
def test_exported_resnet_matches_the_jax_exported_engine(host_resize, tmp_path):
    params = _np_tree(jax_build_resnet("resnet18", 10).init_params(jax.random.PRNGKey(0)))
    kw = dict(model_path="resnet18-seeded", model_type="resnet", input_size=[64, 64],
              resnet_num_classes=10, resnet_top_k=5, resnet_scores="softmax",
              confidence_threshold=1e-6, precision="fp32", warmup=False, device="cpu",
              batch_buckets=[2], max_batch_size=2, host_resize=host_resize)
    jax_path, torch_path = str(tmp_path / "j.rvae"), str(tmp_path / "t.rvae")
    jax_export_serving_artifact(JaxResNetEngine(JaxConfig(**kw), params=params), jax_path,
                                [(120, 160)])
    export_serving_artifact(TorchResNetEngine(DetectorConfig(**kw), params=params),
                            torch_path, [(120, 160)])
    want_eng = JaxExportedResNet(JaxConfig(**{**kw, "model_path": jax_path}))
    got_eng = create_detector(DetectorConfig(**{**kw, "model_path": torch_path}))
    assert isinstance(got_eng, ExportedResNetEngine)
    frames = [_smooth(120, 160, s) for s in range(2)]
    want = want_eng.predict_packets(_packets(frames, True))
    got = got_eng.predict_packets(_packets(frames, False))
    for w, g in zip(want, got):
        assert len(g) > 0 and [d.class_id for d in g] == [d.class_id for d in w]
        np.testing.assert_allclose([d.confidence for d in g], [d.confidence for d in w],
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("model_type", ["cnn_lstm", "3d_cnn"])
def test_exported_temporal_matches_the_jax_exported_engine(model_type, tmp_path):
    params = _np_tree(jax_build_temporal(model_type, 12, "avg").init_params(
        jax.random.PRNGKey(2)))
    kw = dict(model_path="absent-temporal.npz", model_type=model_type, device="cpu",
              input_size=[32, 32], num_action_classes=12, sequence_length=8,
              sequence_stride=1, temporal_overlap=0.5, precision="fp32", warmup=False,
              confidence_threshold=1e-6, batch_buckets=[2], max_batch_size=2,
              host_resize="off")
    jax_path, torch_path = str(tmp_path / "j.rvae"), str(tmp_path / "t.rvae")
    jax_export_serving_artifact(JaxTemporalEngine(JaxConfig(**kw), params=params), jax_path,
                                [(48, 64)])
    export_serving_artifact(TorchTemporalEngine(DetectorConfig(**kw), params=params),
                            torch_path, [(48, 64)])
    want_eng = JaxExportedTemporal(JaxConfig(**{**kw, "model_path": jax_path}))
    got_eng = create_detector(DetectorConfig(**{**kw, "model_path": torch_path}))
    assert isinstance(got_eng, ExportedTemporalEngine)
    seqs = [[_smooth(48, 64, seed=10 * s + t) for t in range(8)] for s in range(2)]
    want = want_eng.predict_clips([_packets(f, True) for f in seqs])
    got = got_eng.predict_clips([_packets(f, False) for f in seqs])
    for w, g in zip(want, got):
        assert len(g) == 5 and [d.class_id for d in g] == [d.class_id for d in w]
        np.testing.assert_allclose([d.confidence for d in g], [d.confidence for d in w],
                                   atol=1e-5, rtol=0)
