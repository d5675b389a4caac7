"""The port's export CLI and the pipeline serving from an artifact, on the CPU.

Counterparts of tests/test_export_engine.py's CLI tests and of
tests/test_export_pipeline.py: ``realtime-analytics-torch-export`` writes
the programs asked for (``--src``, ``--buckets``, ``--input-size``,
``--device``) or those of a pipeline config's streams, and a native
``.onnx`` with ``--output x.onnx``; the pipeline routes ``model_path:
*.rvae`` to the exported engine and every frame reaches the sink.
"""

import asyncio
import json
import os
import sys
import zipfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_export import SRC_PICK, _det_cfg  # noqa: E402

from realtime_analytics_tpu_torch.config import (  # noqa: E402
    KafkaSinkConfig,
    PipelineConfig,
    PrometheusConfig,
    SnapshotConfig,
    StreamConfig,
    TrackerConfig,
)
from realtime_analytics_tpu_torch.engine.detector import TorchYoloEngine  # noqa: E402
from realtime_analytics_tpu_torch.engine.export import (  # noqa: E402
    ExportedYoloEngine,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.models.weights import synthetic_params  # noqa: E402
from realtime_analytics_tpu_torch.models.yolo import build_yolo  # noqa: E402


# -- the CLI ------------------------------------------------------------------------------


def test_export_cli(tmp_path):
    from realtime_analytics_tpu_torch.scripts.export_engine import main

    out = str(tmp_path / "cli.rvae")
    rc = main(["--model", "missing_yolov8n.pt", "--model-type", "yolov8", "--output", out,
               "--src", "192x192", "--input-size", "64x64", "--buckets", "1",
               "--device", "cpu"])
    assert rc == 0 and os.path.exists(out)
    with zipfile.ZipFile(out) as zf:
        meta = json.loads(zf.read("meta.json"))
    names = [p["name"] for p in meta["programs"]]
    assert len(names) == 1 and names[0].startswith("192x192_b1")
    assert meta["input_size"] == [64, 64] and meta["device"] == "cpu"


def test_export_cli_derives_src_from_config_and_writes_onnx(tmp_path):
    from realtime_analytics_tpu_torch.models.onnx_lite import read_onnx_model
    from realtime_analytics_tpu_torch.scripts.export_engine import main

    yaml_path = tmp_path / "p.yaml"
    yaml_path.write_text("""
streams:
  - name: a
    url: "synthetic://?width=128&height=96"
  - name: b
    url: "synthetic://?width=64&height=64"
detector:
  model_path: missing_yolov8n.pt
  model_type: yolov8
  device: cpu
  input_size: [64, 64]
  batch_buckets: [1]
  max_batch_size: 1
  warmup: false
""")
    out = str(tmp_path / "auto.rvae")
    assert main(["--config", str(yaml_path), "--output", out]) == 0
    with zipfile.ZipFile(out) as zf:
        meta = json.loads(zf.read("meta.json"))
    assert {(p["src_h"], p["src_w"]) for p in meta["programs"]} == {(96, 128), (64, 64)}
    onnx_out = str(tmp_path / "native.onnx")
    assert main(["--config", str(yaml_path), "--output", onnx_out]) == 0
    assert read_onnx_model(onnx_out).outputs
    assert main(["--config", str(yaml_path), "--detector-id", "nope",
                 "--output", str(tmp_path / "x.rvae")]) == 2


# -- the pipeline ---------------------------------------------------------------------


def test_pipeline_serves_from_artifact(tmp_path):
    from realtime_analytics_tpu_torch.pipeline import AnalyticsPipeline

    params = synthetic_params(build_yolo("yolov8", "n", 80), seed=0)
    live = TorchYoloEngine(_det_cfg("seeded"), params=params)
    path = str(tmp_path / "pipe.rvae")
    export_serving_artifact(live, path, src_hws=[SRC_PICK])
    cfg = PipelineConfig(
        streams=[StreamConfig(
            name=f"cam-{i}",
            url=f"synthetic://?width={SRC_PICK[1]}&height={SRC_PICK[0]}&boxes=2&seed={i}"
                "&frames=10",
            target_fps=30, warmup_seconds=0.0, max_retries=1, reconnect_backoff=2.0)
            for i in range(2)],
        detector=_det_cfg(path, warmup=True, batch_buckets=None),
        tracker=TrackerConfig(),
        kafka=KafkaSinkConfig(enabled=True, transport="memory"),
        prometheus=PrometheusConfig(enabled=False),
        snapshots=SnapshotConfig(enabled=False),
        stats_interval_seconds=3600,
    )
    pipeline = AnalyticsPipeline(cfg)
    asyncio.run(pipeline.run_for(30.0))  # finite sources: ends well before
    assert isinstance(pipeline.detectors["__default__"], ExportedYoloEngine)
    frames = sum(w.health.total_frames for w in pipeline.workers)
    st = pipeline.batchers["__default__"].stats
    # every frame served or shed (a loaded host can shed at the in-flight cap)
    assert frames + st.shed == 20 and frames >= 10 and st.batches > 0
    assert st.frames == frames and pipeline.kafka.messages_sent == frames
