"""The plain reference against the port's fp32 plain path on the CPU (a test
may import both; the reference imports nothing of the program)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.frames import scene_frames
from benchmark.reference import yolov8 as ref
from benchmark.weights import seeded_state_dict, write_checkpoint


@pytest.fixture(scope="module")
def frames():
    gen = torch.Generator().manual_seed(2**31 + 9)
    scenes = scene_frames(gen, 2, "cpu", (540, 960))
    flat = scene_frames(gen, 1, "cpu", (540, 960), field=0, noise=0)
    return torch.cat([scenes, flat]).numpy()


def port_engine(path: str, precision: str, size: int, batch: int):
    from realtime_analytics_tpu_torch.config import DetectorConfig
    from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine

    return TorchYoloEngine(DetectorConfig(
        model_path=path, model_type="yolov8", device="cpu", confidence_threshold=0.25,
        iou_threshold=0.45, input_size=[size, size], max_batch_size=batch,
        batch_buckets=[batch], max_detections=300, pre_nms_topk=512, precision=precision,
        warmup=False))


@pytest.mark.parametrize("scale", ["n", "l"])
def test_reference_equals_the_port_in_fp32(tmp_path, frames, scale):
    sd = seeded_state_dict(scale, 2**31 + 3, "cpu")
    model = ref.YoloV8(sd, "cpu")
    anchors, dets = ref.run(model, torch.from_numpy(frames), 0.25, 0.45, 512, 300, size=320)
    eng = port_engine(write_checkpoint(sd, str(tmp_path), scale, 3), "fp32", 320, len(frames))
    res = eng.predict_arrays(frames)
    total = 0
    for i, (a, d) in enumerate(zip(anchors, dets)):
        n = int(res.num_valid[i])
        assert n == len(d.scores)
        total += n
        order = np.argsort(-d.scores, kind="stable")
        np.testing.assert_allclose(res.scores[i, :n], d.scores[order], atol=2e-5)
        np.testing.assert_allclose(res.boxes_xyxy[i, :n], d.boxes[order], atol=2e-2)
        np.testing.assert_array_equal(res.class_ids[i, :n], d.classes[order])
        gaps = compare.served_gaps(a, res.boxes_xyxy[i, :n], res.scores[i, :n],
                                   res.class_ids[i, :n])
        assert len(gaps) == 0 or float(gaps.max()) < 1e-4
        assert compare.clear_uncovered(d, res.boxes_xyxy[i, :n], res.scores[i, :n])[1] == 0
    assert total > 0


def test_letterbox_is_the_ports_pick_at_three_to_one(frames):
    geo = ref.Geometry.of(540, 960, 320)
    assert (geo.new_h, geo.new_w, geo.top, geo.left) == (180, 320, 70, 0)
    x = ref.letterbox(torch.from_numpy(frames), geo)
    picked = frames[:, 1::3, 1::3, ::-1].astype(np.float32) / 255.0
    got = x.permute(0, 2, 3, 1)[:, 70:250].numpy()
    np.testing.assert_allclose(got, picked, atol=1e-7)
    assert torch.all(x[:, :, :70] == 114 / 255.0)


def test_gaps_read_wrong_answers(frames):
    sd = seeded_state_dict("n", 2**31 + 4, "cpu")
    anchors, dets = ref.run(ref.YoloV8(sd, "cpu"), torch.from_numpy(frames), 0.25, 0.45,
                            512, 300, size=320)
    counts = [compare.frame_counts(a, d, d.boxes, d.scores, d.classes)
              for a, d in zip(anchors, dets)]
    assert sum(c["served"] for c in counts) > 0 and sum(c["clear"] for c in counts) > 0
    assert compare.shares(counts) == {"served_off": 0.0, "missed": 0.0}
    wrong = {
        "relabelled": [compare.frame_counts(a, d, d.boxes, d.scores, (d.classes + 1) % 80)
                       for a, d in zip(anchors, dets)],
        "moved": [compare.frame_counts(a, d, d.boxes + 300.0, d.scores, d.classes)
                  for a, d in zip(anchors, dets)],
        "rescored": [compare.frame_counts(a, d, d.boxes, d.scores * 0.7, d.classes)
                     for a, d in zip(anchors, dets)],
        "empty": [compare.frame_counts(a, d, d.boxes[:0], d.scores[:0], d.classes[:0])
                  for a, d in zip(anchors, dets)],
    }
    for name, c in wrong.items():
        s = compare.shares(c)
        assert (s["served_off"] or 0) > 50 or s["missed"] > 50, (name, s)
