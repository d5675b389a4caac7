"""The port's serving artifacts (``engine/export.py``) on the CPU: YOLO.

Counterpart of tests/test_export_engine.py and tests/test_export_pipeline.py
for the PyTorch package. The bar is the JAX package's: an exported engine
serving from a ``.rvae`` gives detections bit-identical to the live engine
it was exported from, for every exported (resolution x bucket) program and
the YOLO kinds (fp32 ``sel`` and ``full``, bf16, B4's device letterbox),
and refuses loudly what was not exported. On the CPU the programs run the
kernels' plain versions through the registered ops, as the live engine
does through the wrappers; each engine runs a batch once before the
comparison (the CPU's first convolution of a shape can round otherwise).

Each exported program keeps every kernel as one node of its graph (B1 twice
and B6 once a YOLO step; B2 and B3 on the native v8 float step; B4 on the
device-resize step), holds no weight and no tensor constant larger than a
few elements, and takes the weights from ``params/``; the export itself
fails when a step reads a tensor that is not among its inputs, and leaves
the engine it traced as it was.

int8, YOLOv5, tiling, ResNet, temporal and graph-backed engines, and the
port's artifacts against the JAX package's, are in
tests/test_torch_export_kinds.py, tests/test_torch_export_families.py and
tests/test_torch_export_jax.py; the CLI and the pipeline in
tests/test_torch_export_cli.py.
"""

import io
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.config import ConfigError, DetectorConfig
from realtime_analytics_tpu_torch.engine import export as export_mod
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine, create_detector
from realtime_analytics_tpu_torch.engine.export import (
    ExportedYoloEngine,
    _flatten_params,
    _unflatten_params,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.models.weights import synthetic_params
from realtime_analytics_tpu_torch.models.yolo import build_yolo

INPUT = 64
SRC_PICK = (192, 192)  # 3x on both axes: the host pixel pick ("sel")
SRC_FRAC = (100, 160)  # fractional ratio: full frames ("full"; host resize is off on the CPU)
FIELDS = ("boxes_xyxy", "scores", "class_ids", "num_valid")


def _det_cfg(model_path: str, **kw) -> DetectorConfig:
    base = dict(model_path=model_path, model_type="yolov8", device="cpu",
                input_size=[INPUT, INPUT], batch_buckets=[1, 2], max_batch_size=2,
                confidence_threshold=0.01, warmup=False, precision="fp32")
    base.update(kw)
    return DetectorConfig(**base)


@pytest.fixture(scope="module")
def params():
    return synthetic_params(build_yolo("yolov8", "n", 80), seed=0)


@pytest.fixture(scope="module")
def live_engine(params):
    return TorchYoloEngine(_det_cfg("seeded-yolov8n"), params=params)


@pytest.fixture(scope="module")
def artifact(live_engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("rvae") / "test.rvae")
    return path, export_serving_artifact(live_engine, path, src_hws=[SRC_PICK, SRC_FRAC])


@pytest.fixture(scope="module")
def exported_engine(artifact):
    return ExportedYoloEngine(_det_cfg(artifact[0]))


def _same_detections(live, served, frames):
    live.predict_arrays(frames.copy())
    served.predict_arrays(frames.copy())
    a, b = live.predict_arrays(frames.copy()), served.predict_arrays(frames.copy())
    assert int(a.num_valid.sum()) > 0, "trivial comparison: no detections survived"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _graph_targets(path: str, name: str):
    with zipfile.ZipFile(path) as zf:
        ep = torch.export.load(io.BytesIO(zf.read(f"programs/{name}.pt2")))
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    return ep, targets


def _hold_no_weights(path: str, meta) -> None:
    """Every program of the artifact takes its weights and prepared state
    as inputs: no module state, and no tensor constant past a few elements
    (the scalars a step makes: int8 zero points, a box's four zeros)."""
    for p in meta["programs"]:
        ep, _ = _graph_targets(path, p["name"])
        assert not ep.state_dict, p["name"]
        sizes = [c.numel() for c in ep.constants.values() if isinstance(c, torch.Tensor)]
        assert max(sizes, default=0) <= 16, (p["name"], sizes)


# -- the flat key scheme (copies of the JAX package's helpers) -----------------


def test_flatten_roundtrip_with_list_nodes():
    params = {"layers": {"0": {"w": np.ones((3, 3)), "b": np.zeros(3)},
                         "2": {"m": [{"cv1": {"w": np.full((2,), 2.0)}},
                                     {"cv1": {"w": np.full((2,), 3.0)}}]}}}
    flat = _flatten_params(params)
    assert "layers/2/m/#1/cv1/w" in flat
    back = _unflatten_params(flat)
    assert isinstance(back["layers"]["2"]["m"], list)
    np.testing.assert_array_equal(back["layers"]["2"]["m"][1]["cv1"]["w"],
                                  params["layers"]["2"]["m"][1]["cv1"]["w"])
    np.testing.assert_array_equal(back["layers"]["0"]["w"], params["layers"]["0"]["w"])


def test_flatten_roundtrip_escapes_onnx_scoped_names():
    params = {"/model.22/Constant_output_0": np.arange(4.0),
              "#lit%": np.ones(2),
              "plain.dotted": {"nested/slash": np.zeros(3)}}
    flat = _flatten_params(params)
    assert all(k.count("/") <= 1 for k in flat)  # one separator: the dict nesting
    back = _unflatten_params(flat)
    assert set(back) == set(params)
    np.testing.assert_array_equal(back["/model.22/Constant_output_0"],
                                  params["/model.22/Constant_output_0"])
    np.testing.assert_array_equal(back["#lit%"], params["#lit%"])
    np.testing.assert_array_equal(back["plain.dotted"]["nested/slash"],
                                  params["plain.dotted"]["nested/slash"])


def test_flatten_keeps_torch_tensors_and_their_bytes():
    t = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    flat = _flatten_params({"model": {"a.b": t}, "prep": {"x": [t]}})
    assert flat["model/a.b"] is t and flat["prep/x/#0"] is t
    spec = export_mod._spec_of(t)
    back = export_mod._tensor_from(export_mod._tensor_bytes(t), spec, torch.device("cpu"))
    assert spec["dtype"] == "bfloat16" and torch.equal(back, t)
    cl = torch.randn(2, 3, 4, 5).contiguous(memory_format=torch.channels_last)
    spec = export_mod._spec_of(cl)
    back = export_mod._tensor_from(export_mod._tensor_bytes(cl), spec, torch.device("cpu"))
    assert spec["channels_last"] and back.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(back, cl)


# -- the artifact ----------------------------------------------------------------


def test_artifact_contents(artifact, live_engine):
    path, meta = artifact
    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
    assert "meta.json" in names
    assert {f"programs/{p['name']}.pt2" for p in meta["programs"]} <= names
    assert len(meta["programs"]) == 4  # both resolutions x both buckets
    assert {p["kind"] for p in meta["programs"]} == {"sel", "full"}
    assert meta["input_size"] == [INPUT, INPUT]
    assert meta["framework"] == "torch" and meta["device"] == "cpu"
    assert meta["torch_version"] == torch.__version__ and "jax_version" not in meta
    # the weights once, under params/, every module tensor and the prepared state
    n_model = len(dict(live_engine.model.named_parameters())) + len(
        dict(live_engine.model.named_buffers()))
    assert sum(k.startswith("model/") for k in meta["params"]) == n_model
    assert {"prep/w0_folded/w", "prep/stem_folded/w0", "prep/stem_plain/w0"} <= set(meta["params"])
    assert f"prep/letterbox/{SRC_FRAC[0]}x{SRC_FRAC[1]}/taps" in meta["params"]
    assert {f"params/{k}.bin" for k in meta["params"]} <= names
    full = next(p for p in meta["programs"] if p["kind"] == "full")
    sel = next(p for p in meta["programs"] if p["kind"] == "sel")
    assert any(k.startswith("prep/letterbox/") for k in full["inputs"])
    assert not any(k.startswith("prep/letterbox/") for k in sel["inputs"])


def test_programs_keep_every_kernel_as_one_node_and_no_weights(artifact):
    path, meta = artifact
    for p in meta["programs"]:
        ep, targets = _graph_targets(path, p["name"])
        assert targets.count("rva.row_gather.default") == 2
        assert targets.count("rva.nms_keep_boxes.default") == 1
        assert targets.count("rva.decode_v8_levels.default") == 1
        assert targets.count("rva.fused_stem_p1p2.default") == 1
        # the CPU's auto letterbox is the plain preprocess (B4 runs on the
        # card, or under pallas_preprocess: on — held below)
        assert targets.count("rva.letterbox.default") == 0
        assert not any("equal" in t for t in targets)  # no host sync left
    _hold_no_weights(path, meta)  # the weights are inputs


def test_export_leaves_the_engine_as_it_was(params, tmp_path):
    """The trace binds a copy: the live engine keeps its own model and
    prepared tensors (it may serve while it is exported)."""
    live = TorchYoloEngine(_det_cfg("seeded-yolov8n", classes=[0, 2]), params=params)
    before = {k: v for k, v in vars(live).items() if k != "_operands"}
    weights = dict(live.model.named_parameters())
    export_serving_artifact(live, str(tmp_path / "a.rvae"), src_hws=[SRC_PICK, SRC_FRAC])
    after = vars(live)
    assert all(after[k] is v for k, v in before.items())
    assert all(t is weights[n] for n, t in live.model.named_parameters())
    assert set(live._operands) == {SRC_FRAC}  # B4's tables, kept for the live path too


def test_bind_gives_a_copy_reading_the_given_state(live_engine):
    state = live_engine.prepared_state([SRC_FRAC])
    assert {"w0_folded", "stem_folded", "stem_plain", "letterbox"} <= set(state)
    swapped = {**state, "stem_plain": {k: v.clone() for k, v in state["stem_plain"].items()}}
    bound = live_engine.bind("a model", swapped)
    assert bound is not live_engine and bound.model == "a model"
    assert bound._stem_plain.w1 is swapped["stem_plain"]["w1"]
    assert bound._stem_plain.dtype == live_engine._stem_plain.dtype
    assert live_engine._stem_plain.w1 is state["stem_plain"]["w1"]
    assert bound.operands_for(SRC_FRAC).taps is state["letterbox"]["100x160"]["taps"]
    with pytest.raises(ValueError, match="not in the bound state"):
        bound.operands_for(SRC_PICK)  # would otherwise be baked into the program
    with pytest.raises(ValueError, match="lacks"):
        live_engine.bind("a model", {k: v for k, v in state.items() if k != "stem_folded"})


def test_a_tensor_left_out_of_the_prepared_state_fails_the_export(params, tmp_path,
                                                                   monkeypatch):
    live = TorchYoloEngine(_det_cfg("seeded-yolov8n"), params=params)
    own = TorchYoloEngine._own_state

    def without_the_folded_stem(self):
        return {k: v for k, v in own(self).items() if k != "stem_folded"}

    monkeypatch.setattr(TorchYoloEngine, "_own_state", without_the_folded_stem)
    monkeypatch.setattr(TorchYoloEngine, "_bind_own", lambda self, state: None)
    path = tmp_path / "baked.rvae"
    with pytest.raises(ValueError, match="not its inputs"):
        export_serving_artifact(live, str(path), src_hws=[SRC_PICK])
    assert not os.listdir(tmp_path)


def test_roundtrip_bit_identical(live_engine, exported_engine):
    rng = np.random.default_rng(7)
    for hw in (SRC_PICK, SRC_FRAC):
        for n in (1, 2):
            _same_detections(live_engine, exported_engine,
                             rng.integers(0, 256, (n, *hw, 3), dtype=np.uint8))


def test_a_program_checks_its_inputs_on_its_first_call(artifact):
    eng = ExportedYoloEngine(_det_cfg(artifact[0]))
    with pytest.raises(Exception, match="(?i)shape|size|dim"):
        eng._run_program(SRC_PICK, torch.zeros((1, 10, 10, 3), dtype=torch.uint8), "sel")
    assert "192x192_b1_sel" not in eng._loaded_programs
    ok = torch.zeros((1, INPUT, INPUT, 3), dtype=torch.uint8)
    with torch.inference_mode():
        eng._run_program(SRC_PICK, ok, "sel")
    program, inputs = eng._loaded_programs["192x192_b1_sel"]
    assert program.validate_inputs is False and len(inputs) > 100


def test_factory_routes_rvae(artifact):
    assert isinstance(create_detector(_det_cfg(artifact[0])), ExportedYoloEngine)


def test_engine_family_mismatch_rejected(artifact):
    with pytest.raises(ConfigError, match="artifact serves a 'yolo' engine"):
        create_detector(_det_cfg(artifact[0], model_type="resnet", resnet_num_classes=10))


def test_unexported_resolution_raises(exported_engine):
    with pytest.raises(ConfigError, match="480x640") as ei:
        exported_engine.predict_arrays(np.zeros((1, 480, 640, 3), np.uint8))
    assert "192x192_b1" in str(ei.value)  # the list of exported programs


def test_oversized_batch_raises(exported_engine):
    with pytest.raises(ValueError, match="largest exported bucket 2"):
        exported_engine.predict_arrays(np.zeros((3, *SRC_PICK, 3), np.uint8))


def test_warmup_times_exported_buckets(artifact):
    eng = ExportedYoloEngine(_det_cfg(artifact[0]))
    eng.warmup(SRC_PICK)
    costs = eng._bucket_cost_ms[SRC_PICK]
    assert set(costs) == {1, 2} and all(c > 0 for c in costs.values())
    assert eng._effective_bucket(1, SRC_PICK) in (1, 2)


def test_warmup_host_drift_raises_config_error(artifact):
    # exported with the pixel pick ('sel'); a host path without it needs a
    # 'full' program the artifact does not have
    eng = ExportedYoloEngine(_det_cfg(artifact[0]))
    eng.config.host_select = "off"
    with pytest.raises(ConfigError, match="192x192_b1_full"):
        eng.warmup(SRC_PICK)


def test_empty_src_hws_rejected(live_engine, tmp_path):
    with pytest.raises(ValueError, match="at least one source resolution"):
        export_serving_artifact(live_engine, str(tmp_path / "e.rvae"), src_hws=[])
    with pytest.raises(ValueError, match=r"must end with \.rvae"):
        export_serving_artifact(live_engine, str(tmp_path / "e.zip"), src_hws=[SRC_PICK])


def test_failed_export_leaves_no_artifact(live_engine, tmp_path, monkeypatch):
    path = str(tmp_path / "broken.rvae")

    def boom(*a, **k):
        raise RuntimeError("unexportable op")

    monkeypatch.setattr(export_mod.torch.export, "export", boom)
    with pytest.raises(RuntimeError, match="unexportable"):
        export_serving_artifact(live_engine, path, src_hws=[SRC_PICK])
    assert not os.path.exists(path)
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_mesh_config_rejected_at_serve(artifact):
    with pytest.raises(ConfigError, match="traced for one device"):
        ExportedYoloEngine(_det_cfg(artifact[0], mesh_shape=[2, 1]))


def test_mesh_engine_refuses_export(live_engine, tmp_path):
    live_engine.mesh = object()
    try:
        with pytest.raises(ValueError, match="single-device"):
            export_serving_artifact(live_engine, str(tmp_path / "x.rvae"), src_hws=[SRC_PICK])
    finally:
        del live_engine.mesh


def test_re_export_of_an_exported_engine_refused(exported_engine, tmp_path):
    with pytest.raises(ValueError, match="cannot re-export"):
        export_serving_artifact(exported_engine, str(tmp_path / "x.rvae"), src_hws=[SRC_PICK])


def test_traced_knob_drift_warns(artifact, caplog):
    with caplog.at_level("WARNING"):
        ExportedYoloEngine(_det_cfg(artifact[0], classes=[0, 2]))
    assert any("classes" in r.message and "traced-in" in r.message for r in caplog.records)


def _rewrite_meta(path, victim, edit):
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(victim, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "meta.json":
                meta = json.loads(data)
                edit(meta)
                data = json.dumps(meta)
            zout.writestr(item, data)
    return str(victim)


def test_device_mismatch_rejected(artifact, tmp_path):
    victim = _rewrite_meta(artifact[0], tmp_path / "wrongdev.rvae",
                           lambda m: m.update(device="cuda"))
    with pytest.raises(ConfigError, match="re-export on this device"):
        ExportedYoloEngine(_det_cfg(victim))


def test_jax_made_artifact_refused_by_name(artifact, tmp_path):
    def as_jax(meta):
        meta.pop("framework")
        meta.pop("torch_version")
        meta.pop("device")
        meta.update(jax_version="0.4.35", platforms=["cpu"])

    victim = _rewrite_meta(artifact[0], tmp_path / "jaxmade.rvae", as_jax)
    with pytest.raises(ConfigError, match="JAX-made .rvae.*realtime-analytics-torch-export"):
        create_detector(_det_cfg(victim))


def test_device_rules_hold_for_artifacts(artifact):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: auto means the card")
    with pytest.raises(RuntimeError, match="device: cpu"):
        create_detector(_det_cfg(artifact[0], device="auto"))


# -- the other YOLO kinds ------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bf16", "device_letterbox"])
def test_yolo_kinds_roundtrip_bit_identical(kind, params, tmp_path):
    over = {"bf16": dict(precision="bf16"),
            "device_letterbox": dict(pallas_preprocess="on")}[kind]
    live = TorchYoloEngine(_det_cfg("seeded", batch_buckets=[2], **over), params=params)
    src = SRC_FRAC if kind == "device_letterbox" else SRC_PICK
    path = str(tmp_path / f"{kind}.rvae")
    meta = export_serving_artifact(live, path, src_hws=[src])
    served = create_detector(_det_cfg(path, **over))
    assert isinstance(served, ExportedYoloEngine)
    frames = np.random.default_rng(11).integers(0, 256, (2, *src, 3), np.uint8)
    _same_detections(live, served, frames)
    _, targets = _graph_targets(path, meta["programs"][0]["name"])
    assert targets.count("rva.row_gather.default") == 2
    assert targets.count("rva.nms_keep_boxes.default") == 1
    assert targets.count("rva.decode_v8_levels.default") == 1
    assert targets.count("rva.fused_stem_p1p2.default") == 1
    assert targets.count("rva.letterbox.default") == (kind == "device_letterbox")
