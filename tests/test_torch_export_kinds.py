"""The port's serving artifacts on the CPU: native int8, YOLOv5 and tiling.

Each exported engine serves detections bit-identical to the live engine it
was exported from (tests/test_torch_export.py states the bar). int8: the
quantised weights and the activation scales calibrated at export are in
``params/`` and the exported engine does not calibrate. YOLOv5: a v5 head
(no B2) and a k6 stem (no B3). Tiling: the input-sized program of the tile
crops is exported beside the source's and warmed with it.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_export import (  # noqa: E402
    FIELDS,
    INPUT,
    SRC_PICK,
    _det_cfg,
    _graph_targets,
    _hold_no_weights,
    _same_detections,
)

from realtime_analytics_tpu_torch.engine import detector as detector_mod  # noqa: E402
from realtime_analytics_tpu_torch.engine.detector import (  # noqa: E402
    TorchYoloEngine,
    create_detector,
)
from realtime_analytics_tpu_torch.engine.export import (  # noqa: E402
    ExportedYoloEngine,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.models.weights import synthetic_params  # noqa: E402
from realtime_analytics_tpu_torch.models.yolo import build_yolo  # noqa: E402


@pytest.mark.parametrize("kind", ["int8", "yolov5"])
def test_yolo_kinds_roundtrip_bit_identical(kind, tmp_path, monkeypatch):
    model_type = "yolov5" if kind == "yolov5" else "yolov8"
    over = dict(precision="int8") if kind == "int8" else dict(model_type="yolov5")
    params = synthetic_params(build_yolo(model_type, "n", 80), seed=0)
    live = TorchYoloEngine(_det_cfg("seeded", batch_buckets=[2], **over), params=params)
    path = str(tmp_path / f"{kind}.rvae")
    meta = export_serving_artifact(live, path, src_hws=[SRC_PICK])

    def no_calibration(*a, **k):
        raise AssertionError("an exported engine must not calibrate")

    monkeypatch.setattr(detector_mod, "calibrate_int8_activations", no_calibration)
    served = create_detector(_det_cfg(path, **over))
    assert isinstance(served, ExportedYoloEngine)
    frames = np.random.default_rng(11).integers(0, 256, (2, *SRC_PICK, 3), np.uint8)
    _same_detections(live, served, frames)
    _, targets = _graph_targets(path, meta["programs"][0]["name"])
    assert targets.count("rva.row_gather.default") == 2
    assert targets.count("rva.nms_keep_boxes.default") == 1
    assert targets.count("rva.decode_v8_levels.default") == (kind == "int8")
    assert targets.count("rva.fused_stem_p1p2.default") == 0  # int8 and v5: no fused stem
    _hold_no_weights(path, meta)
    if kind == "int8":  # the calibrated scales come from the file
        assert meta["precision"] == "int8"
        assert {"prep/w0_folded/w_pack", "prep/w0_folded/a_scale"} <= set(meta["params"])
        assert sum(k.endswith(".a_scale") for k in meta["params"]) > 50
        assert meta["params"]["model/layers.0.w_q"]["dtype"] == "int8"


def test_tiling_export_includes_input_hw_and_serves(tmp_path):
    over = dict(tiling=True, tiling_overlap=0.2, batch_buckets=[2])
    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)
    live = TorchYoloEngine(_det_cfg("seeded", **over), params=params)
    path = str(tmp_path / "tiled.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(128, 128)])
    assert (INPUT, INPUT) in {(p["src_h"], p["src_w"]) for p in meta["programs"]}
    served = ExportedYoloEngine(_det_cfg(path, **over))
    served.warmup((128, 128))
    assert (INPUT, INPUT) in served._bucket_cost_ms  # warmup recursed into the tiles
    frames = list(np.random.default_rng(2).integers(0, 256, (1, 128, 128, 3), np.uint8))
    live._predict_tiled_group(frames, (128, 128))  # each engine's first run of the shapes
    served._predict_tiled_group(frames, (128, 128))
    a = live._predict_tiled_group(frames, (128, 128))
    b = served._predict_tiled_group(frames, (128, 128))
    assert int(a.num_valid.sum()) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
