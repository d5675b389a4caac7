"""The clip pack's native gather (``native/frames.c``) against numpy's stack.

``TorchTemporalEngine._pack`` copies every frame of a call's clips into the
staging buffer in one native call (``native.frames.gather``) where the frames
are at the step's frame shape (no host resize), uint8 and C-contiguous; the
pad slots (bucket > clips) take the last clip's frames. Anything else, and
``RVA_NO_NATIVE``, stacks with numpy a clip. Held here, on the CPU: the
packed bytes equal numpy's on every path, ``ClipStats.frames_gathered``
counts the frames the gather copied (0 on the numpy path), and through
``predict_clips`` the step's input and the returned logits are those of the
numpy pack.
"""

import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
from realtime_analytics_tpu_torch.models.temporal import build_temporal
from realtime_analytics_tpu_torch.models.weights import temporal_synthetic_params
from realtime_analytics_tpu_torch.native import frames as native_frames
from realtime_analytics_tpu_torch.types import FramePacket

T, HW, NC = 8, 32, 12


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    return temporal_synthetic_params(build_temporal("3d_cnn", NC), seed=3)


def engine(params, **over):
    kw = dict(model_type="3d_cnn", model_path="clip-gather-seeded", device="cpu",
              precision="fp32", input_size=[HW, HW], num_action_classes=NC,
              sequence_length=T, batch_buckets=[4], max_batch_size=4, warmup=False,
              confidence_threshold=1e-6)
    kw.update(over)
    return TorchTemporalEngine(DetectorConfig(**kw), params=params)


def ring(seed, n=24, h=HW, w=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def clips_of(frames_at, offsets, stride=2):
    """A clip a camera: T frames every ``stride`` from each offset."""
    return [[FramePacket(StreamConfig(name=f"cam-{c}"), frames_at(o + stride * t), t, 0.0)
             for t in range(T)] for c, o in enumerate(offsets)]


def shared_ring(seed=0, **kw):
    frames = ring(seed, **kw)
    return lambda j: frames[j % len(frames)]


def separate_arrays(seed=0, **kw):
    frames = ring(seed, **kw)
    return lambda j: frames[j % len(frames)].copy()


def stacked(seqs, bucket):
    """numpy's pack: the clips stacked, padded by repeating the last."""
    out = np.stack([np.stack([p.frame for p in s]) for s in seqs])
    return np.concatenate([out, np.repeat(out[-1:], bucket - len(seqs), 0)])


def pack(eng, seqs, bucket):
    hw = seqs[0][0].frame.shape[:2]
    buf, resized = eng._pack(seqs, list(range(len(seqs))), hw, bucket)
    try:
        return buf.numpy()[:bucket].copy(), resized
    finally:
        eng._staging.give(buf)


@pytest.fixture
def numpy_only(monkeypatch):
    """The gather as a build without a native library (``RVA_NO_NATIVE``)."""
    monkeypatch.setenv("RVA_NO_NATIVE", "1")
    monkeypatch.setattr(native_frames, "_tried", False)
    monkeypatch.setattr(native_frames, "_lib", None)


def test_the_native_build_is_there():
    assert native_frames._load() is not None and native_frames.threads() >= 1


@pytest.mark.parametrize("frames", [shared_ring, separate_arrays])
@pytest.mark.parametrize("n,bucket", [(3, 3), (3, 4), (1, 4)])
def test_gather_equals_numpy_stack(params, frames, n, bucket):
    eng = engine(params)
    seqs = clips_of(frames(), [0, 5, 11][:n])
    got, resized = pack(eng, seqs, bucket)
    assert not resized
    np.testing.assert_array_equal(got, stacked(seqs, bucket))
    assert eng.stats.frames_gathered == bucket * T


def test_gather_at_a_frame_shape_the_step_resizes(params):
    """Frames larger than the input, with no host resize (the CPU's
    ``auto``), go to the step as they are: the gather takes them."""
    eng = engine(params)
    seqs = clips_of(shared_ring(h=48, w=64), [0, 3])
    got, resized = pack(eng, seqs, 4)
    assert not resized
    np.testing.assert_array_equal(got, stacked(seqs, 4))
    assert eng.stats.frames_gathered == 4 * T


def test_a_non_contiguous_frame_takes_the_numpy_path(params):
    eng = engine(params)
    wide = ring(1, w=2 * HW)
    seqs = clips_of(shared_ring(), [0, 4])
    seqs[1][3] = FramePacket(seqs[1][3].stream, wide[0, :, ::2], 3, 0.0)
    assert not seqs[1][3].frame.flags.c_contiguous
    got, _ = pack(eng, seqs, 3)
    np.testing.assert_array_equal(got, stacked(seqs, 3))
    assert eng.stats.frames_gathered == 0


def test_no_native_takes_the_numpy_path(params, numpy_only):
    eng = engine(params)
    seqs = clips_of(shared_ring(), [2, 7, 9])
    got, _ = pack(eng, seqs, 4)
    np.testing.assert_array_equal(got, stacked(seqs, 4))
    assert eng.stats.frames_gathered == 0 and native_frames.threads() == 0


def test_host_resize_gathers_nothing(params):
    pytest.importorskip("cv2")
    eng = engine(params, host_resize="on")
    seqs = clips_of(shared_ring(h=48, w=64), [0, 3])
    _, resized = pack(eng, seqs, 2)
    assert resized and eng.stats.frames_gathered == 0


def test_gather_refuses_what_it_cannot_copy():
    frames = list(ring(2, n=4))
    out = np.zeros((4, HW, HW, 3), np.uint8)
    assert not native_frames.gather([*frames[:3], frames[3][:, ::-1]], out)
    assert not native_frames.gather([*frames[:3], frames[3].astype(np.int16)], out)
    assert not native_frames.gather([*frames[:3], frames[3][:-1]], out)
    assert not native_frames.gather(frames[:3], out)
    assert not out.any()  # nothing copied
    assert not native_frames.gather(frames, out[:, ::2])
    assert not native_frames.gather(frames, out.astype(np.float32))


def test_gather_takes_read_only_and_repeated_frames():
    frames = list(ring(3, n=3))
    frames[1].flags.writeable = False
    order = [frames[0], frames[1], frames[1], frames[2], frames[0]]
    out = np.zeros((5, HW, HW, 3), np.uint8)
    assert native_frames.gather(order, out)
    np.testing.assert_array_equal(out, np.stack(order))


def _served(eng, seqs):
    """predict_clips' logits, and the step's input as the step read it."""
    inputs = []
    run_step = eng._run_step

    def recording(key, clips):
        inputs.append(clips.clone())
        return run_step(key, clips)

    eng._run_step = recording
    _, logits = eng.predict_clips(seqs, return_logits=True)
    return inputs, logits


@pytest.mark.parametrize("n", [4, 3])
def test_predict_clips_serves_what_the_numpy_pack_serves(params, monkeypatch, n):
    seqs = clips_of(shared_ring(5), [0, 6, 13, 20][:n])
    eng = engine(params)
    inputs, logits = _served(eng, seqs)
    assert eng.stats.frames_gathered == 4 * T and eng.stats.frames_packed == n * T
    monkeypatch.setattr(native_frames, "gather", lambda frames, out: False)
    ref = engine(params)
    want_inputs, want = _served(ref, seqs)
    assert ref.stats.frames_gathered == 0
    assert len(inputs) == len(want_inputs) == 1
    assert torch.equal(inputs[0], want_inputs[0])
    np.testing.assert_array_equal(inputs[0].numpy(), stacked(seqs, 4))
    np.testing.assert_array_equal(logits, want)
