"""The engines' step cache (``engine/graphs.py``) on the CPU.

The port keeps one prepared step per key, as the JAX engine keeps one
``jax.jit`` program: ``_steps`` holds the same keys as the JAX engine's
``_steps`` after the same warmup (YOLO: host pick, device resize, tiling;
ResNet and temporal: host-resized and full frames). On the CPU an entry is
the eager step itself, so the cached step
is bit-equal to calling it; on the card it is a ``CapturedStep``, whose
bookkeeping (static input, shape and dtype checks, the lock, the launch
counts a replay adds, the copies of its outputs) runs here with a stand-in
for the CUDA graph that recomputes the outputs in place at each replay.
An engine made to capture through the stand-in serves what the eager
engine serves, bit for bit. ``unletterbox_boxes``, which now takes its
geometry as numbers, equals the JAX version exactly in fp32.
"""

import sys
import threading

import numpy as np
import pytest
import torch

from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
from realtime_analytics_tpu.engine.detector import JaxResNetEngine, JaxYoloEngine
from realtime_analytics_tpu.engine.temporal import JaxTemporalEngine
from realtime_analytics_tpu.ops.boxes import unletterbox_boxes as jax_unletterbox
from realtime_analytics_tpu_torch.config import DetectorConfig, StreamConfig
from realtime_analytics_tpu_torch.engine import graphs
from realtime_analytics_tpu_torch.engine.detector import TorchResNetEngine, TorchYoloEngine
from realtime_analytics_tpu_torch.engine.export import (
    ExportedYoloEngine,
    export_serving_artifact,
)
from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
from realtime_analytics_tpu_torch.ops._cuda import LAUNCHES
from realtime_analytics_tpu_torch.ops.boxes import unletterbox_boxes
from realtime_analytics_tpu_torch.ops.preprocess import letterbox_spec
from realtime_analytics_tpu_torch.types import FramePacket

INPUT = 64


def _kw(**over):
    kw = dict(model_path="__random__.pt", model_type="yolov8", device="cpu",
              confidence_threshold=0.01, warmup=False, input_size=[INPUT, INPUT],
              max_batch_size=2, batch_buckets=[1, 2], precision="fp32", host_resize="off")
    kw.update(over)
    return kw


def _frames(hw, n=2, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


class StandInGraph:
    """What ``CapturedStep`` asks of ``graphs.CudaGraph``, on the CPU: the
    capture keeps the step and its outputs; a replay runs the step again on
    the static input and writes its results into those outputs, counting
    nothing (a replayed graph does not pass through the wrappers)."""

    def __init__(self, pool):
        self.pool = pool

    def warm(self, fn, x):
        for _ in range(graphs.WARM_RUNS):
            fn(x)

    def capture(self, fn, x):
        self.fn, self.x = fn, x
        self.outputs = tuple(fn(x))
        return self.outputs

    def replay(self):
        before = LAUNCHES.local()
        results = self.fn(self.x)
        after = LAUNCHES.local()
        for name in after:
            LAUNCHES.add(name, before[name] - after[name])
        for out, res in zip(self.outputs, results):
            out.copy_(res)


def _stand_in_cache():
    cache = graphs.StepCache()
    cache._pool = ("stand-in",)  # no card: no graph_pool_handle()
    return cache


def _captured(fn, shape=(2, 4, 4, 3), dtype=torch.uint8, cache=None, key=(2, 4, 4)):
    return graphs.CapturedStep(fn, shape, dtype, torch.device("cpu"), key=key,
                               cache=cache or _stand_in_cache(), graph_type=StandInGraph)


def _toy_step(x):
    """Stands in for a YOLO step: counts B1 twice, B2 and B6 once, and
    returns four outputs of the step's dtypes."""
    LAUNCHES.add("row_gather", 2)
    LAUNCHES.add("decode_v8")
    LAUNCHES.add("nms_keep")
    xf = x.to(torch.float32)
    return (xf[..., :2] * 0.5, xf.mean(dim=(1, 2, 3)), x[:, 0, 0, :].to(torch.int32),
            x.to(torch.int32).sum(dim=(1, 2, 3)))


# -- the keys: JAX's ----------------------------------------------------------


@pytest.mark.parametrize("case", ["host_pick", "device_resize", "tiled"])
def test_steps_keys_match_jax(case):
    src, over = {"host_pick": ((192, 192), {}),
                 "device_resize": ((100, 90), {}),
                 "tiled": ((128, 192), dict(tiling=True, tiling_full_frame=True))}[case]
    jax_engine = JaxYoloEngine(JaxConfig(**_kw(**over)))
    port = TorchYoloEngine(DetectorConfig(**_kw(**over)))
    jax_engine.warmup(src)
    port.warmup(src)
    assert set(port._steps) == set(jax_engine._steps)
    assert set(port._bucket_cost_ms) == set(jax_engine._bucket_cost_ms)
    want_sel = case != "device_resize"
    assert any(len(k) == 4 and k[3] == "sel" for k in port._steps) == want_sel
    if case == "tiled":  # the input-sized step of the tile crops is keyed too
        assert {(1, INPUT, INPUT, "sel"), (2, INPUT, INPUT, "sel")} <= set(port._steps)
    # on the CPU every entry is the eager step
    assert all(isinstance(s, graphs.EagerStep) for s in port._steps.values())


# ResNet-18 at 64 and CNN-LSTM clips of 4 at 32x32, as their parity tests
CLASSIFIERS = {
    "resnet": (JaxResNetEngine, TorchResNetEngine,
               dict(model_path="resnet18-seeded", model_type="resnet", input_size=[64, 64],
                    resnet_num_classes=10)),
    "temporal": (JaxTemporalEngine, TorchTemporalEngine,
                 dict(model_path="absent-temporal.npz", model_type="cnn_lstm",
                      input_size=[32, 32], num_action_classes=5, sequence_length=4)),
}


@pytest.mark.parametrize("host_resize", ["on", "off"], ids=["host_resized", "full_frame"])
@pytest.mark.parametrize("family", sorted(CLASSIFIERS))
def test_classifier_steps_keys_match_jax(family, host_resize):
    """The ResNet and temporal engines keep their steps in ``_steps`` under
    JAX's keys, ``(B, "rsz")`` or ``(B, H, W)``, each an ``EagerStep``."""
    jax_cls, port_cls, over = CLASSIFIERS[family]
    kw = dict(device="cpu", warmup=False, precision="fp32", batch_buckets=[1, 2],
              max_batch_size=2, host_resize=host_resize, **over)
    jax_engine, port = jax_cls(JaxConfig(**kw)), port_cls(DetectorConfig(**kw))
    src = (48, 40)
    jax_engine.warmup(src)
    port.warmup(src)
    want = {(1, "rsz"), (2, "rsz")} if host_resize == "on" else {(1, *src), (2, *src)}
    assert set(port._steps) == set(jax_engine._steps) == want
    assert set(port._bucket_cost_ms) == set(jax_engine._bucket_cost_ms) == {src}
    assert set(port._bucket_cost_ms[src]) == set(jax_engine._bucket_cost_ms[src]) == {1, 2}
    assert all(isinstance(s, graphs.EagerStep) for s in port._steps.values())
    assert not port._captures()


def test_temporal_logits_step_has_its_own_key():
    """The port's logits variant, which JAX has not, is a key of its own;
    the step of a call that does not ask for logits brings back two
    outputs, the top-5 scores and classes."""
    _, _, over = CLASSIFIERS["temporal"]
    eng = TorchTemporalEngine(DetectorConfig(
        device="cpu", warmup=False, precision="fp32", batch_buckets=[1], max_batch_size=1,
        host_resize="off", **over))
    stream = StreamConfig(name="cam")
    clip = [FramePacket(stream, f, i, 0.0) for i, f in enumerate(_frames((48, 40), n=4))]
    eng.predict_clips([clip])
    _, logits = eng.predict_clips([clip], return_logits=True)
    assert set(eng._steps) == {(1, 48, 40), (1, 48, 40, "logits")}
    clips = np.stack([np.stack([p.frame for p in clip])])
    assert len(eng._steps[(1, 48, 40)].run_host(clips)) == 2
    got = eng._steps[(1, 48, 40, "logits")].run_host(clips)[2]
    np.testing.assert_array_equal(got, logits)


def test_cached_step_is_the_eager_step_bit_for_bit():
    eng = TorchYoloEngine(DetectorConfig(**_kw()))
    for hw, selected in (((192, 192), True), ((100, 90), False)):
        frames = _frames(hw)
        got = eng.predict_arrays(frames)
        host, sel = eng.host_prepare(frames, hw)
        assert sel == selected
        spec = letterbox_spec(hw, eng.input_hw)
        fn = eng._step_selected if selected else eng._step_device_resize
        with torch.inference_mode():
            want = [t.numpy() for t in fn(torch.from_numpy(host), spec)]
        for field, w in zip(("boxes_xyxy", "scores", "class_ids", "num_valid"), want):
            np.testing.assert_array_equal(getattr(got, field), w)
    assert set(eng._steps) == {(2, 192, 192, "sel"), (2, 100, 90)}


@pytest.mark.parametrize("hw", [(192, 192), (100, 90)], ids=["sel", "device_resize"])
def test_an_engine_that_captures_serves_what_the_eager_engine_serves(hw, monkeypatch):
    """The card's path of ``_run_bucket`` (static input of the key's shape,
    one replay, outputs copied out), with the stand-in graph: results
    bit-equal to the eager engine's, a second batch's included."""
    eager = TorchYoloEngine(DetectorConfig(**_kw()))
    captured = TorchYoloEngine(DetectorConfig(**_kw()))
    captured._steps._pool = ("stand-in",)
    monkeypatch.setattr(TorchYoloEngine, "_captures", lambda self: self is captured)
    monkeypatch.setattr(graphs, "CudaGraph", StandInGraph)
    a, b = _frames(hw, seed=1), _frames(hw, seed=2)
    eager.predict_arrays(b)  # as the captured engine's warm runs: a first call of each shape
    first = captured.predict_arrays(a)
    second = captured.predict_arrays(b)
    steps = list(captured._steps.values())
    assert len(steps) == 1 and isinstance(steps[0], graphs.CapturedStep)
    for got, frames in ((first, a), (second, b)):
        want = eager.predict_arrays(frames)
        for field in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


def test_an_eager_twin_serves_eager_steps_of_its_own(monkeypatch):
    """``eager_twin`` (what ``chip_smoke.py`` holds a captured step to):
    the same model and state, a cache of eager steps and bucket costs of
    its own, the captured engine's results bit for bit."""
    captured = TorchYoloEngine(DetectorConfig(**_kw()))
    captured._steps._pool = ("stand-in",)
    monkeypatch.setattr(TorchYoloEngine, "_captures", lambda self: self is captured)
    monkeypatch.setattr(graphs, "CudaGraph", StandInGraph)
    captured.warmup((192, 192))
    twin = captured.eager_twin()
    assert twin.model is captured.model and twin._bucket_cost_ms == {}
    frames = _frames((192, 192), seed=3)
    got, want = twin.predict_arrays(frames), captured.predict_arrays(frames)
    assert [type(s) for s in twin._steps.values()] == [graphs.EagerStep]
    assert all(isinstance(s, graphs.CapturedStep) for s in captured._steps.values())
    for field in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))


# -- unletterbox_boxes ----------------------------------------------------------


@pytest.mark.parametrize("src_hw", [(1080, 1920), (720, 1280), (480, 854), (97, 211),
                                    (640, 640), (1520, 2688)])
def test_unletterbox_boxes_equals_jax_exactly(src_hw):
    import jax.numpy as jnp

    spec = letterbox_spec(src_hw, (640, 640))
    boxes = (np.random.default_rng(3).random((3, 50, 4)) * 700 - 30).astype(np.float32)
    got = unletterbox_boxes(torch.from_numpy(boxes), spec.scale, spec.pad_left,
                            spec.pad_top, *src_hw).numpy()
    want = np.asarray(jax_unletterbox(jnp.asarray(boxes), spec.scale, spec.pad_left,
                                      spec.pad_top, *src_hw))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


# -- CapturedStep's bookkeeping ---------------------------------------------------


def test_replays_add_the_launches_of_the_eager_step():
    LAUNCHES.reset()
    _toy_step(torch.zeros((2, 4, 4, 3), dtype=torch.uint8))
    eager = LAUNCHES.snapshot()
    LAUNCHES.reset()
    step = _captured(_toy_step)
    # the warm runs launched; the capture launched nothing
    assert LAUNCHES.snapshot() == {k: graphs.WARM_RUNS * v for k, v in eager.items()}
    assert step.launches == {k: v for k, v in eager.items() if v}
    for calls in (1, 3):
        LAUNCHES.reset()
        for _ in range(calls):
            step.run_host(_frames((4, 4)))
        assert LAUNCHES.snapshot() == {k: calls * v for k, v in eager.items()}


@pytest.mark.parametrize("shape,dtype", [((1, 4, 4, 3), torch.uint8),
                                         ((2, 4, 5, 3), torch.uint8),
                                         ((2, 4, 4, 3), torch.float32)],
                         ids=["batch", "width", "dtype"])
def test_a_batch_of_another_shape_or_dtype_raises(shape, dtype):
    step = _captured(_toy_step)
    with pytest.raises(ValueError, match=r"captured for torch.uint8 \(2, 4, 4, 3\)"):
        step(torch.zeros(shape, dtype=dtype))
    with pytest.raises(ValueError, match="captured for"):
        step.run_host(torch.zeros(shape, dtype=dtype).numpy())


def test_outputs_are_copies_that_a_later_call_leaves_alone():
    step = _captured(_toy_step)
    a, b = _frames((4, 4), seed=1), _frames((4, 4), seed=2)
    host_a = step.run_host(a)
    dev_a = step(torch.from_numpy(a))
    want = [t.numpy().copy() for t in _toy_step(torch.from_numpy(a))]
    step.run_host(b)
    step(torch.from_numpy(b))
    for got_host, got_dev, w in zip(host_a, dev_a, want):
        np.testing.assert_array_equal(got_host, w)
        np.testing.assert_array_equal(got_dev.numpy(), w)


def test_four_threads_at_once_give_serial_results():
    step = _captured(_toy_step)
    batches = [_frames((4, 4), seed=s) for s in range(8)]
    serial = [step.run_host(b) for b in batches]
    results, errors = {}, []

    def work(t):
        try:
            for r in range(25):
                i = (t + r) % len(batches)
                results[(t, r)] = (i, step.run_host(batches[i]))
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    assert len(results) == 100
    for i, got in results.values():
        for g, w in zip(got, serial[i]):
            np.testing.assert_array_equal(g, w)


def test_a_failed_capture_raises_naming_the_key():
    class Refuses(StandInGraph):
        def capture(self, fn, x):
            raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match=r"\(2, 4, 4, 'sel'\) failed: operation not"):
        graphs.CapturedStep(_toy_step, (2, 4, 4, 3), torch.uint8, torch.device("cpu"),
                            key=(2, 4, 4, "sel"), cache=_stand_in_cache(),
                            graph_type=Refuses)


def test_a_key_is_made_once_when_threads_ask_at_once():
    cache, made = graphs.StepCache(), []
    barrier = threading.Barrier(4)

    def make():
        made.append(1)
        return object()

    def ask():
        barrier.wait(timeout=30)
        got.append(cache.setdefault_made((2, 4, 4), make))

    got = []
    threads = [threading.Thread(target=ask) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert len(made) == 1 and len(got) == 4 and len({id(g) for g in got}) == 1


# -- the exported engine -------------------------------------------------------


def test_exported_engine_keys_its_steps_and_keeps_every_loaded_program(tmp_path):
    live = TorchYoloEngine(DetectorConfig(**_kw()))
    path = str(tmp_path / "m.rvae")
    meta = export_serving_artifact(live, path, src_hws=[(192, 192), (100, 90)])
    eng = ExportedYoloEngine(DetectorConfig(**_kw(model_path=path)))
    assert eng._steps == {} and eng._loaded_programs == {}
    for hw in ((192, 192), (100, 90)):
        eng.warmup(hw)
        live.warmup(hw)
    assert set(eng._steps) == set(live._steps) == {
        (1, 192, 192, "sel"), (2, 192, 192, "sel"), (1, 100, 90), (2, 100, 90)}
    assert set(eng._loaded_programs) == {p["name"] for p in meta["programs"]}
    for program, inputs in eng._loaded_programs.values():
        assert program.validate_inputs is False and len(inputs) > 100
    frames = _frames((192, 192))
    got, want = eng.predict_arrays(frames), live.predict_arrays(frames)
    for field in ("boxes_xyxy", "scores", "class_ids", "num_valid"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
