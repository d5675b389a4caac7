"""The port's temporal models and engine against the JAX package, on the CPU.

1. Each family's ``forward`` against JAX ``apply`` on the same params tree
   (JAX ``init_params``, carried across as numpy through
   ``temporal_params_from_jax``), fp32, at the JAX package's widths on
   narrow clips [2, 8, 32, 32, 3]; both pooling modes of the recurrent
   models. Tolerance atol 2e-4 / rtol 2e-4, as the JAX package's
   checkpoint test (tests/test_temporal_checkpoints.py): convolutions and
   matmuls sum in fp32 in another order, and the recurrences carry the
   difference over 8 steps.
2. ``temporal_params_from_state_dict`` against JAX's, on state dicts of
   that test's torch mirrors: equal trees (atol 0, both are numpy
   transposes and one fp32 bias sum).
3. The buffering contract: clips, overlap retention, the reset on a change
   of frame shape and on ``reset_stream``, frame id for frame id against
   ``JaxTemporalEngine.buffer_packet``.
4. ``TorchTemporalEngine(device: cpu)`` against ``JaxTemporalEngine`` end
   to end (``predict_clips``), host resize on and off: equal top-5 classes,
   softmax scores atol 1e-5.
5. Clip coalescing through the port's ``InferenceBatcher`` with the real
   engine: clips that complete in different batcher ticks run as one
   ``predict_clips`` call and give the detections the engine gives alone.
"""

import asyncio
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.config import StreamConfig as JaxStream
from realtime_analytics_tpu.engine.temporal import JaxTemporalEngine
from realtime_analytics_tpu.models.temporal import build_temporal as jax_build_temporal
from realtime_analytics_tpu.models.weights import (
    temporal_params_from_state_dict as jax_temporal_params_from_state_dict,
)
from realtime_analytics_tpu.types import FramePacket as JaxPacket
from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
from realtime_analytics_tpu_torch.engine.batcher import InferenceBatcher
from realtime_analytics_tpu_torch.engine.detector import create_detector
from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
from realtime_analytics_tpu_torch.models.temporal import build_temporal
from realtime_analytics_tpu_torch.models.weights import (
    load_temporal_checkpoint,
    module_tree,
    temporal_params_from_jax,
    temporal_params_from_state_dict,
    temporal_synthetic_params,
)
from realtime_analytics_tpu_torch.types import FramePacket, TemporalDetection

cv2 = pytest.importorskip("cv2")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = ["cnn_lstm", "conv_gru", "3d_cnn", "slow_fast"]
NC = 12


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _jax_params(model_type, seed=0, pooling="avg"):
    return _np_tree(jax_build_temporal(model_type, NC, pooling).init_params(
        jax.random.PRNGKey(seed)))


def _mirrors():
    spec = importlib.util.spec_from_file_location(
        "temporal_checkpoint_mirrors",
        os.path.join(REPO, "tests", "test_temporal_checkpoints.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _assert_trees_close(a, b, atol):
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y), atol=atol, rtol=0)


@pytest.mark.parametrize("model_type,pooling", [
    ("cnn_lstm", "avg"), ("cnn_lstm", "max"), ("cnn_lstm", "last"),
    ("conv_gru", "avg"), ("conv_gru", "max"), ("conv_gru", "last"),
    ("3d_cnn", "avg"), ("slow_fast", "avg"),
])
def test_forward_matches_jax_apply(model_type, pooling):
    jm = jax_build_temporal(model_type, NC, pooling)
    params = _np_tree(jm.init_params(jax.random.PRNGKey(1)))
    clip = np.random.default_rng(0).normal(0, 1, (2, 8, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(params, jnp.asarray(clip)))
    model = temporal_params_from_jax(build_temporal(model_type, NC, pooling), params).eval()
    with torch.no_grad():
        got = model(torch.from_numpy(clip))
    assert got.dtype == torch.float32 and got.shape == (2, NC)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)
    _assert_trees_close(module_tree(model), params, atol=0)


@pytest.mark.parametrize("model_type", FAMILIES)
def test_state_dict_mapping_matches_jax(model_type, tmp_path):
    mirrors = _mirrors()
    torch.manual_seed(7)
    sd = mirrors._state_dict(mirrors.MIRRORS[model_type]().eval())
    model = build_temporal(model_type, NC)
    want = jax_temporal_params_from_state_dict(jax_build_temporal(model_type, NC), sd)
    got = temporal_params_from_state_dict(model, sd)
    _assert_trees_close(got, _np_tree(want), atol=0)
    path = tmp_path / f"{model_type}.npz"  # the flat torch-named carrier
    np.savez(path, **sd)
    _assert_trees_close(load_temporal_checkpoint(model, str(path)), got, atol=0)


def test_checkpoint_carriers_and_refusals(tmp_path):
    mirrors = _mirrors()
    torch.manual_seed(3)
    tm = mirrors.TorchCNNLSTM().eval()
    model = build_temporal("cnn_lstm", NC)
    want = temporal_params_from_state_dict(model, mirrors._state_dict(tm))
    torch.save(tm.state_dict(), tmp_path / "w.pt")
    _assert_trees_close(load_temporal_checkpoint(model, str(tmp_path / "w.pt")), want, atol=0)
    np.savez(tmp_path / "tree.npz", __pytree__=np.array(want, dtype=object))
    _assert_trees_close(load_temporal_checkpoint(model, str(tmp_path / "tree.npz")), want,
                        atol=0)
    assert load_temporal_checkpoint(model, str(tmp_path / "w.onnx")) is None
    assert load_temporal_checkpoint(model, str(tmp_path / "absent.pt")) is None
    a, b = temporal_synthetic_params(model, 2), temporal_synthetic_params(model, 2)
    _assert_trees_close(a, b, atol=0)
    temporal_params_from_jax(model, a)


def _cfg(model_type="cnn_lstm", **over):
    hw = [32, 32]
    kw = dict(model_path="absent-temporal.npz", model_type=model_type, device="cpu",
              input_size=hw, num_action_classes=NC, sequence_length=8,
              sequence_stride=1, temporal_overlap=0.5, precision="fp32", warmup=False,
              confidence_threshold=1e-6, batch_buckets=[2], max_batch_size=2)
    kw.update(over)
    return kw


def _smooth(h, w, seed):
    small = np.random.default_rng(seed).integers(0, 256, (h // 8 + 1, w // 8 + 1, 3), np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


def _packets(stream_cls, packet_cls, name, frames, start=0):
    stream = stream_cls(name=name, url="x")
    return [packet_cls(stream=stream, frame=f, frame_id=start + i, timestamp=0.0)
            for i, f in enumerate(frames)]


def test_buffering_contract_matches_jax():
    over = dict(sequence_length=4, sequence_stride=2, temporal_overlap=0.5)
    params = _jax_params("cnn_lstm")
    jax_engine = JaxTemporalEngine(JaxConfig(**_cfg(**over)), params=params)
    engine = TorchTemporalEngine(DetectorConfig(**_cfg(**over)), params=params)
    small, big = np.zeros((24, 32, 3), np.uint8), np.zeros((48, 64, 3), np.uint8)
    frames = [small] * 13 + [big] * 11  # a resolution change at frame 13
    got, want = [], []
    for p in _packets(StreamConfig, FramePacket, "cam", frames):
        seq = engine.buffer_packet(p)
        got.append(None if seq is None else [q.frame_id for q in seq])
    for p in _packets(JaxStream, JaxPacket, "cam", frames):
        seq = jax_engine.buffer_packet(p)
        want.append(None if seq is None else [q.frame_id for q in seq])
    assert got == want
    assert got[7] == [0, 2, 4, 6]  # 4 frames at stride 2 out of 8 buffered
    assert got[9] == [2, 4, 6, 8]  # step 2: 6 of the 8 frames retained
    assert got[13:20] == [None] * 7 and got[20] == [13, 15, 17, 19]  # reset at 13
    assert got[22] == [15, 17, 19, 21] and engine.buffered("cam") == 7
    engine.reset_stream("cam")
    assert engine.buffered("cam") == 0


@pytest.mark.parametrize("model_type", FAMILIES)
@pytest.mark.parametrize("host_resize", ["on", "off"])
def test_engine_matches_jax_engine(model_type, host_resize):
    params = _jax_params(model_type, seed=2)
    over = dict(host_resize=host_resize)
    jax_engine = JaxTemporalEngine(JaxConfig(**_cfg(model_type, **over)), params=params)
    engine = create_detector(DetectorConfig(**_cfg(model_type, **over)))
    assert isinstance(engine, TorchTemporalEngine)
    engine = TorchTemporalEngine(DetectorConfig(**_cfg(model_type, **over)), params=params)
    seqs = [[_smooth(48, 64, seed=10 * s + t) for t in range(8)] for s in range(2)]
    want = jax_engine.predict_clips(
        [_packets(JaxStream, JaxPacket, f"c{s}", f) for s, f in enumerate(seqs)])
    got = engine.predict_clips(
        [_packets(StreamConfig, FramePacket, f"c{s}", f) for s, f in enumerate(seqs)])
    for w, g in zip(want, got):
        assert len(g) == 5 and all(isinstance(d, TemporalDetection) for d in g)
        assert [d.class_id for d in g] == [d.class_id for d in w]
        np.testing.assert_allclose([d.confidence for d in g], [d.confidence for d in w],
                                   atol=1e-5, rtol=0)
        assert [(d.sequence_start_frame, d.sequence_end_frame, d.action_label, d.bbox_xyxy)
                for d in g] == [(d.sequence_start_frame, d.sequence_end_frame,
                                 d.action_label, d.bbox_xyxy) for d in w]


def test_clip_coalescing_drives_the_real_engine():
    """Three streams complete clips in different batcher ticks; the window
    parks them and one predict_clips call runs all three (bucket 4), with
    the detections the engine gives for the same clips alone."""
    over = dict(sequence_length=4, batch_buckets=[4], max_batch_size=4)
    params = _jax_params("cnn_lstm", seed=4)
    engine = TorchTemporalEngine(DetectorConfig(**_cfg(**over)), params=params)
    alone = TorchTemporalEngine(DetectorConfig(**_cfg(**over)), params=params)
    streams = {f"s{i}": [_smooth(48, 64, seed=20 * i + t) for t in range(4)] for i in range(3)}
    calls = []
    real = engine.predict_clips
    engine.predict_clips = lambda seqs: calls.append(len(seqs)) or real(seqs)

    async def run():
        batcher = InferenceBatcher(engine, max_batch=8, batch_window_ms=1,
                                   temporal_clip_window_ms=300)
        await batcher.start()
        try:
            futs = {}
            for t in range(4):
                for name, frames in streams.items():
                    pkt = FramePacket(stream=StreamConfig(name=name, url="x"),
                                      frame=frames[t], frame_id=t, timestamp=0.0)
                    futs[(name, t)] = batcher.submit_nowait(pkt)
                    await asyncio.sleep(0.01)  # each frame in its own tick
            return {k: await f for k, f in futs.items()}, batcher.stats.snapshot()
        finally:
            await batcher.stop()

    results, stats = asyncio.run(run())
    assert calls == [3] and stats["clip_batches"] == 1 and stats["clips"] == 3
    for name, frames in streams.items():
        assert all(results[(name, t)] == [] for t in range(3))
        want = alone.predict_clips([_packets(StreamConfig, FramePacket, name, frames)])[0]
        got = results[(name, 3)]
        assert [d.class_id for d in got] == [d.class_id for d in want]
        np.testing.assert_allclose([d.confidence for d in got],
                                   [d.confidence for d in want], atol=1e-6, rtol=0)
