"""The port's tiled inference against the JAX package's, on the CPU.

``ops/tiling.py`` is a numpy copy: on every case of tests/test_tiling.py
and on seeded random detections its grid, crops and merges must equal the
JAX package's exactly. The tiled engine path (``_predict_tiled_group``)
runs fp32 on the same He-scaled weights in both packages: detections frame
by frame with equal counts and classes, boxes atol 1e-2 px, scores atol
1e-4 (the engine bounds of tests/test_torch_engine.py).
"""

import importlib.util
import os

import numpy as np
import pytest

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.engine.detector import JaxYoloEngine
from realtime_analytics_tpu.ops import tiling as jt
from realtime_analytics_tpu_torch.config import ConfigError, DetectorConfig, StreamConfig
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine, create_detector
from realtime_analytics_tpu_torch.ops import tiling as tt
from realtime_analytics_tpu_torch.types import FramePacket

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# the numpy helpers, case by case against the JAX package's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src", [(1080, 1920), (720, 1280), (1440, 2560), (643, 641),
                                 (480, 640), (640, 640), (640, 1280), (100, 170)])
@pytest.mark.parametrize("overlap", [0.0, 0.2, 0.5])
def test_tile_grid_equals_jax(src, overlap):
    tile = (64, 64) if src == (100, 170) else (640, 640)
    got = tt.tile_grid(src, tile, overlap)
    assert got == jt.tile_grid(src, tile, overlap)
    mask = np.zeros(src, bool)
    for y0, x0 in got:
        mask[y0:y0 + tile[0], x0:x0 + tile[1]] = True
        assert 0 <= y0 <= max(0, src[0] - tile[0]) and 0 <= x0 <= max(0, src[1] - tile[1])
    assert mask.all() and len(got) == len(set(got))


def test_grid_of_1080p_is_8_tiles():
    assert len(tt.tile_grid((1080, 1920), (640, 640), 0.2)) == 8
    assert [x for _, x in tt.tile_grid((640, 1280), (640, 640), 0.5)] == [0, 320, 640]


@pytest.mark.parametrize("y0,x0", [(10, 20), (60, 80), (0, 0), (99, 119)])
def test_crop_tile_equals_jax(y0, x0):
    frame = (np.arange(100 * 120 * 3, dtype=np.int64).reshape(100, 120, 3) % 251).astype(np.uint8)
    got, want = np.empty((64, 64, 3), np.uint8), np.empty((64, 64, 3), np.uint8)
    tt.crop_tile(frame, y0, x0, (64, 64), got)
    jt.crop_tile(frame, y0, x0, (64, 64), want)
    np.testing.assert_array_equal(got, want)
    h, w = min(64, 100 - y0), min(64, 120 - x0)
    np.testing.assert_array_equal(got[:h, :w], frame[y0:y0 + h, x0:x0 + w])
    assert (got[h:] == 114).all() and (got[:, w:] == 114).all()


MERGE_CASES = {
    # a box cut at a seam: IoU 0.125, IoS 1.0 -> one box
    "seam_cut": ([[100, 100, 180, 180], [100, 100, 110, 180]], [0.9, 0.6], [2, 2], 10, True),
    "distinct_by_score": ([[0, 0, 10, 10], [50, 50, 60, 60], [90, 0, 99, 9]],
                          [0.5, 0.9, 0.7], [0, 1, 2], 10, True),
    "class_agnostic": ([[0, 0, 10, 10], [0, 0, 10, 10]], [0.9, 0.8], [0, 5], 10, True),
    "class_aware": ([[0, 0, 10, 10], [0, 0, 10, 10]], [0.9, 0.8], [0, 5], 10, False),
    "capped": ([[i * 20, 0, i * 20 + 10, 10] for i in range(20)],
               list(np.linspace(0.9, 0.1, 20)), [0] * 20, 5, True),
    "empty": (np.zeros((0, 4)), [], [], 5, True),
    "equal_scores": ([[0, 0, 10, 10], [5, 0, 15, 10], [30, 30, 40, 40]], [0.5, 0.5, 0.5],
                     [1, 1, 1], 10, True),
}


@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_merge_tile_detections_equals_jax(name):
    boxes, scores, classes, max_det, agnostic = MERGE_CASES[name]
    args = (np.asarray(boxes, np.float32).reshape(-1, 4), np.asarray(scores, np.float32),
            np.asarray(classes, np.int32), 0.45, max_det)
    got = tt.merge_tile_detections(*args, class_agnostic=agnostic)
    _equal(got, jt.merge_tile_detections(*args, class_agnostic=agnostic))
    if name == "seam_cut":
        assert got[3] == 1 and got[1][0] == np.float32(0.9)
    if name == "capped":
        assert got[3] == 5


@pytest.mark.parametrize("agnostic", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_merge_tile_detections_fuzz_equals_jax(seed, agnostic):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 80))
    xy = rng.uniform(0, 300, (k, 2))
    wh = rng.uniform(2, 60, (k, 2))
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.choice(np.linspace(0.05, 0.95, 12), k).astype(np.float32)  # ties too
    classes = rng.integers(0, 3, k).astype(np.int32)
    args = (boxes, scores, classes, float(rng.uniform(0.3, 0.7)), int(rng.integers(1, 40)))
    _equal(tt.merge_tile_detections(*args, class_agnostic=agnostic),
           jt.merge_tile_detections(*args, class_agnostic=agnostic))


def test_offset_and_clip_equals_jax():
    boxes = np.array([[600, 600, 700, 700], [-5, 3, 20, 2000]], np.float32)
    got = tt.offset_and_clip(boxes, 440, 1280, (1080, 1920))
    np.testing.assert_array_equal(got, jt.offset_and_clip(boxes, 440, 1280, (1080, 1920)))
    np.testing.assert_array_equal(got[0], [1880, 1040, 1920, 1080])


def test_merge_frame_equals_jax():
    """A tile result (tile coordinates) and an extra whole-frame pass
    (frame coordinates) seeing one object merge to the pass's box."""
    grid = [(0, 0), (0, 100)]
    t0 = (np.zeros((5, 4), np.float32), np.zeros(5, np.float32), np.zeros(5, np.int32), 0)
    t1 = (np.array([[0, 10, 40, 50]] + [[0, 0, 0, 0]] * 4, np.float32),
          np.array([0.8, 0, 0, 0, 0], np.float32), np.zeros(5, np.int32), 1)
    extra = (np.array([[100, 10, 140, 50]] + [[0, 0, 0, 0]] * 4, np.float32),
             np.array([0.9, 0, 0, 0, 0], np.float32), np.zeros(5, np.int32), 1)
    for parts in ([t0, t1, extra], [t0, t1], [t0]):
        got = tt.merge_frame(parts, grid, (200, 300), 0.45, 10)
        _equal(got, jt.merge_frame(parts, grid, (200, 300), 0.45, 10))
    got = tt.merge_frame([t0, t1, extra], grid, (200, 300), 0.45, 10)
    assert got[3] == 1
    np.testing.assert_array_equal(got[0][0], [100, 10, 140, 50])


# ---------------------------------------------------------------------------
# the engine path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def weights_npz(tmp_path_factory):
    spec = importlib.util.spec_from_file_location(
        "gen_golden_fixture", os.path.join(REPO, "scripts", "gen_golden_fixture.py"))
    fixture = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fixture)
    path = tmp_path_factory.mktemp("wt") / "yolov8n_synthetic.npz"
    np.savez(path, **fixture.synthetic_weights())
    return str(path)


def _kw(path, **over):
    kw = dict(model_path=path, model_type="yolov8", device="cpu",
              confidence_threshold=0.25, iou_threshold=0.45, input_size=[128, 128],
              max_batch_size=4, batch_buckets=[2, 4], max_detections=50, pre_nms_topk=128,
              precision="fp32", warmup=False, host_resize="off", tiling=True,
              tiling_overlap=0.2, tiling_full_frame=False)
    kw.update(over)
    return kw


@pytest.fixture(scope="module")
def scenes():
    """Three 240x330 crops of the golden scene (a 3x3 grid of 128 tiles at
    overlap 0.2), and one 128x128 crop (no tiling)."""
    scene = cv2.imread(os.path.join(REPO, "tests", "data", "golden_scene.png"))
    big = [scene[y:y + 240, x:x + 330] for y, x in ((350, 150), (520, 760), (600, 1250))]
    return big, scene[300:428, 100:228]


def _packets(frames):
    return [FramePacket(StreamConfig(name=f"cam-{i}", url="synthetic://"), f, i, 0.0)
            for i, f in enumerate(frames)]


def _hold(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert len(a) == len(b)
        assert [d.class_id for d in a] == [d.class_id for d in b]
        for da, db in zip(a, b):
            np.testing.assert_allclose(da.bbox_xyxy, db.bbox_xyxy, atol=1e-2)
            assert abs(da.confidence - db.confidence) <= 1e-4
            assert (da.stream_name, da.frame_id) == (db.stream_name, db.frame_id)


@pytest.mark.parametrize("full_frame", [False, True])
def test_tiled_engine_matches_jax(weights_npz, scenes, full_frame):
    """Three frames x 9 tiles = 27 tiles in chunks of the largest bucket
    (4), the selected step on each; with the whole-frame pass merged in."""
    big, _ = scenes
    kw = _kw(weights_npz, tiling_full_frame=full_frame)
    want = JaxYoloEngine(JaxConfig(**kw)).predict_packets(_packets(big))
    eng = TorchYoloEngine(DetectorConfig(**kw))
    calls = []
    run = eng._predict_prepared
    eng._predict_prepared = lambda f, hw, sel: calls.append((len(f), hw, sel)) or run(f, hw, sel)
    got = eng.predict_packets(_packets(big))
    tiles = [c for c in calls if c[1] == (128, 128)]
    assert [c[0] for c in tiles] == [4] * 6 + [3] and all(c[2] for c in tiles)
    assert len(calls) - len(tiles) == (1 if full_frame else 0)
    assert sum(len(d) for d in want) >= 10
    _hold(got, want)


def test_tiled_engine_matches_manual_composition(weights_npz, scenes):
    """The engine glue (crop loop, chunking, coordinates) against cropping
    by hand, running the untiled engine and merging with the ops."""
    big, _ = scenes
    eng = TorchYoloEngine(DetectorConfig(**_kw(weights_npz)))
    plain = TorchYoloEngine(DetectorConfig(**_kw(weights_npz, tiling=False)))
    frame = big[1]
    got = eng.predict_packets(_packets([frame]))[0]
    grid = tt.tile_grid(frame.shape[:2], (128, 128), 0.2)
    tiles = np.empty((len(grid), 128, 128, 3), np.uint8)
    for t, (y0, x0) in enumerate(grid):
        tt.crop_tile(frame, y0, x0, (128, 128), out=tiles[t])
    per_tile = []
    for lo in range(0, len(grid), 4):
        br = plain.predict_arrays(tiles[lo:lo + 4])
        per_tile += [(br.boxes_xyxy[t], br.scores[t], br.class_ids[t], int(br.num_valid[t]))
                     for t in range(len(br.num_valid))]
    b, s, c, n = tt.merge_frame(per_tile, grid, frame.shape[:2], 0.45, 50)
    assert len(got) == n > 0
    for j, d in enumerate(got):
        np.testing.assert_allclose(d.bbox_xyxy, b[j], atol=1e-4)
        assert d.confidence == pytest.approx(float(s[j]), abs=1e-6) and d.class_id == int(c[j])


def test_tiling_inactive_for_input_sized_frames(weights_npz, scenes):
    _, small = scenes
    tiled = TorchYoloEngine(DetectorConfig(**_kw(weights_npz)))
    plain = TorchYoloEngine(DetectorConfig(**_kw(weights_npz, tiling=False)))
    assert not tiled._tiling_active((128, 128)) and tiled._tiling_active((129, 64))
    _hold(tiled.predict_packets(_packets([small])), plain.predict_packets(_packets([small])))


def test_tiled_frames_align_with_solo_runs(weights_npz, scenes):
    """Chunks straddle frames (27 tiles in chunks of 4): each frame's
    result equals running it alone."""
    big, _ = scenes
    eng = TorchYoloEngine(DetectorConfig(**_kw(weights_npz, tiling_full_frame=True)))
    together = eng.predict_packets(_packets(big))
    for i, f in enumerate(big):
        solo = eng.predict_packets(_packets([f]))[0]
        assert len(solo) == len(together[i])
        for a, b in zip(solo, together[i]):
            np.testing.assert_allclose(a.bbox_xyxy, b.bbox_xyxy, atol=1e-4)
            assert a.class_id == b.class_id


def test_tiled_boxes_stay_in_the_frame_and_descend(weights_npz, scenes):
    big, _ = scenes
    eng = create_detector(DetectorConfig(**_kw(weights_npz, tiling_full_frame=True)))
    for dets, f in zip(eng.predict_packets(_packets(big)), big):
        h, w = f.shape[:2]
        for d in dets:
            x1, y1, x2, y2 = d.bbox_xyxy
            assert 0 <= x1 <= x2 <= w and 0 <= y1 <= y2 <= h
        scores = [d.confidence for d in dets]
        assert scores == sorted(scores, reverse=True)


def test_tiled_warmup_warms_the_input_sized_step(weights_npz):
    eng = TorchYoloEngine(DetectorConfig(**_kw(weights_npz, batch_buckets=[2],
                                                max_batch_size=2)))
    eng.warmup((240, 330))
    assert set(eng._bucket_cost_ms) == {(240, 330), (128, 128)}


def test_tiling_overlap_is_validated():
    with pytest.raises(ConfigError):
        DetectorConfig(model_path="x.pt", tiling_overlap=0.95).validate()
    DetectorConfig(model_path="x.pt", tiling_overlap=0.5).validate()
