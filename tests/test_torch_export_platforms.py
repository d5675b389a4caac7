"""The platforms of the port's serving artifacts (``engine/export.py``).

Counterpart of the JAX package's ``export_serving_artifact(...,
platforms=)`` and ``--platforms``: an artifact names the device types it
has programs for in ``meta.json``'s ``platforms``, each program row its
``platform``; serving takes the current device type's programs and refuses
an artifact without them in the JAX package's words. On the CPU only
``cpu`` programs can be traced (``cuda`` raises without a card; ``tpu`` is
refused by name), so the several-platform layout (``programs/<platform>/``)
is held through a rewritten artifact, as is the layout of the package's
earlier artifacts (``device``, no ``platforms``), which still serve. The
two-platform export itself runs on the card in ``chip_smoke.py``.
"""

import json
import zipfile

import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.config import ConfigError, DetectorConfig
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine, create_detector
from realtime_analytics_tpu_torch.engine.export import (
    ExportedYoloEngine,
    export_platforms,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.models.weights import synthetic_params
from realtime_analytics_tpu_torch.models.yolo import build_yolo

SRC = (192, 192)  # a 3x pixel pick at 64: the selected step
FIELDS = ("boxes_xyxy", "scores", "class_ids", "num_valid")
NO_CARD = not torch.cuda.is_available()


def _cfg(path, **kw):
    base = dict(model_path=path, model_type="yolov8", device="cpu", input_size=[64, 64],
                batch_buckets=[2], max_batch_size=2, confidence_threshold=0.01,
                warmup=False, precision="fp32")
    base.update(kw)
    return DetectorConfig(**base)


@pytest.fixture(scope="module")
def live():
    return TorchYoloEngine(_cfg("seeded-yolov8n"),
                           params=synthetic_params(build_yolo("yolov8", "n", 80), seed=0))


@pytest.fixture(scope="module")
def artifact(live, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("platforms") / "cpu.rvae")
    return path, export_serving_artifact(live, path, src_hws=[SRC], platforms=["cpu"])


def _frames():
    return np.random.default_rng(3).integers(0, 256, (2, *SRC, 3), np.uint8)


def _same(live, served):
    frames = _frames()
    live.predict_arrays(frames.copy())
    served.predict_arrays(frames.copy())
    a, b = live.predict_arrays(frames.copy()), served.predict_arrays(frames.copy())
    assert int(a.num_valid.sum()) > 0
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _rewrite(path, victim, edit_meta, rename=lambda name: name):
    """A copy of the artifact with its meta edited and its files renamed."""
    with zipfile.ZipFile(path) as zin, zipfile.ZipFile(victim, "w") as zout:
        for item in zin.infolist():
            data = zin.read(item.filename)
            if item.filename == "meta.json":
                meta = json.loads(data)
                edit_meta(meta)
                data = json.dumps(meta)
            zout.writestr(rename(item.filename), data)
    return str(victim)


def test_platforms_meta(artifact):
    path, meta = artifact
    assert meta["platforms"] == ["cpu"] and meta["device"] == "cpu"
    assert all(p["platform"] == "cpu" and p["file"] == f"programs/{p['name']}.pt2"
               for p in meta["programs"])
    with zipfile.ZipFile(path) as zf:
        assert {p["file"] for p in meta["programs"]} <= set(zf.namelist())


def test_absent_platform_refused_in_jax_words(artifact, tmp_path):
    def cuda_only(meta):
        meta.pop("device")
        meta["platforms"] = ["cuda"]
        for p in meta["programs"]:
            p["platform"] = "cuda"

    victim = _rewrite(artifact[0], tmp_path / "cuda.rvae", cuda_only)
    with pytest.raises(ConfigError, match=r"exported for platforms \['cuda'\], current "
                                          r"device is 'cpu' — re-export on this platform"):
        create_detector(_cfg(victim))


def test_several_platforms_serve_their_own_programs(live, artifact, tmp_path):
    """Two platforms' rows, files under programs/<platform>/: the CPU
    serves the cpu rows (the cuda rows name files the CPU never reads)."""
    def two(meta):
        meta.pop("device")
        meta["platforms"] = ["cuda", "cpu"]
        cpu = meta["programs"]
        cuda = [dict(p, platform="cuda", file=f"programs/cuda/{p['name']}.pt2") for p in cpu]
        for p in cpu:
            p["file"] = f"programs/cpu/{p['name']}.pt2"
        meta["programs"] = cuda + cpu

    victim = _rewrite(artifact[0], tmp_path / "two.rvae", two,
                      lambda n: n.replace("programs/", "programs/cpu/"))
    served = ExportedYoloEngine(_cfg(victim))
    assert {p["platform"] for p in served._programs.values()} == {"cpu"}
    _same(live, served)


def test_earlier_artifact_layout_still_serves(live, artifact, tmp_path):
    """An artifact of the package's earlier layout (meta ``device``, no
    ``platforms``, rows without platform or file) serves as a one-platform
    artifact, bit-equal to the live engine."""
    def earlier(meta):
        meta.pop("platforms")
        for p in meta["programs"]:
            p.pop("platform")
            p.pop("file")

    served = ExportedYoloEngine(_cfg(_rewrite(artifact[0], tmp_path / "old.rvae", earlier)))
    _same(live, served)


def test_platform_names_checked():
    assert export_platforms(None, "cpu") == ["cpu"]
    assert export_platforms(["CPU", " cpu"], "cuda") == ["cpu"]
    with pytest.raises(ValueError, match="platform 'tpu'.*JAX package"):
        export_platforms(["cpu", "tpu"], "cpu")
    with pytest.raises(ValueError, match="unknown platform 'rocm'"):
        export_platforms(["rocm"], "cpu")


@pytest.mark.skipif(not NO_CARD, reason="a card is visible")
def test_cuda_platform_without_a_card_raises(live, tmp_path):
    with pytest.raises(RuntimeError, match="platform 'cuda' needs a CUDA card"):
        export_serving_artifact(live, str(tmp_path / "x.rvae"), src_hws=[SRC],
                                platforms=["cuda", "cpu"])
    assert not (tmp_path / "x.rvae").exists()


def test_cli_platforms(tmp_path, capsys):
    from realtime_analytics_tpu_torch.scripts.export_engine import main

    base = ["--model", "missing_yolov8n.pt", "--model-type", "yolov8", "--src", "192x192",
            "--input-size", "64x64", "--buckets", "1", "--device", "cpu"]
    out = str(tmp_path / "cli.rvae")
    assert main(base + ["--output", out, "--platforms", "cpu"]) == 0
    with zipfile.ZipFile(out) as zf:
        assert json.loads(zf.read("meta.json"))["platforms"] == ["cpu"]
    assert "platforms=['cpu']" in capsys.readouterr().out
    assert main(base + ["--output", str(tmp_path / "t.rvae"), "--platforms", "cpu,tpu"]) == 2
    assert "platform 'tpu'" in capsys.readouterr().err
    if NO_CARD:
        assert main(base + ["--output", str(tmp_path / "c.rvae"), "--platforms", "cuda"]) == 2
        assert "needs a CUDA card" in capsys.readouterr().err
    assert not (tmp_path / "t.rvae").exists() and not (tmp_path / "c.rvae").exists()
