"""The port's in-process (dp, tp) mesh (``parallel/mesh.py``) on the CPU.

Counterpart of tests/test_parallel.py, on the mesh ``[cpu] * 8`` (the
counterpart of its virtual 8-device CPU mesh), at its tolerances: sharded
inference equal to one device within rtol 1e-4, atol 1e-3; an engine's
detections boxes rtol 1e-4 atol 1e-2, scores rtol 1e-4 atol 1e-5; B1's
sharded form bit-equal to its unsharded one, and B4's against the plain
resize at that file's letterbox tolerances (boxes rtol 1e-2 atol 1 px,
scores rtol 5e-2 atol 5e-3). The port's sharded engine is also held
against the JAX package's sharded engine on the same params and frames
(tests/test_torch_engine.py's bounds: boxes atol 1e-2 px, scores atol
1e-4), and the ResNet and temporal mesh engines against one device. The
three ``sp`` cases of tests/test_parallel.py have their counterparts on the
(dp, sp, tp) mesh (2, 2, 2) (``parallel/spatial.py``): the train step
lowers the loss (lr 1e-3, the port's rule above), its loss is one device's
within 1e-6 relative, sharded inference equals one device at rtol 1e-4,
atol 1e-3, and the engine's step over it equals one device's and the JAX
package's three-axis sharded step at tests/test_torch_engine.py's bounds;
each banded op (k1 s1, k3 s1, k3 s2, v5's k6 s2 p2, SPPF, the fused
``up_concat``) at sp 2, 3 and 4 with uneven bands equals the whole op at
fp32 rtol 1e-5, atol 1e-6. YOLOv8n at 64², nc 8-16, batches of 4-8.
"""

import jax
import numpy as np
import pytest
import torch

from realtime_analytics_tpu_torch.config import DetectorConfig
from realtime_analytics_tpu_torch.engine.detector import TorchResNetEngine, TorchYoloEngine
from realtime_analytics_tpu_torch.models.weights import params_to_tree, synthetic_params
from realtime_analytics_tpu_torch.models.yolo import build_yolo
from realtime_analytics_tpu_torch.parallel.mesh import (
    AXES_SP,
    ShardedModel,
    batch_sharding,
    dp_map,
    make_mesh,
    param_shardings,
    shard_params,
)
from realtime_analytics_tpu_torch.parallel.train import (
    anchor_centers,
    make_train_step,
    synthetic_targets,
)

CPU8 = [torch.device("cpu")] * 8
HW = (96, 128)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the test workers then do not oversubscribe the
    cores (several processes of 8 threads each on 8 cores slow down up to
    100-fold)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def tree():
    return synthetic_params(build_yolo("yolov8", "n", 16), seed=0)


def _cfg(**over):
    kw = dict(model_path="__random__.pt", device="cpu", input_size=[64, 64],
              confidence_threshold=0.01, max_batch_size=8, batch_buckets=[8],
              precision="fp32", warmup=False, pre_nms_topk=64, max_detections=16,
              num_classes=16)
    kw.update(over)
    return DetectorConfig(**kw)


def _frames(seed, n=8, hw=HW):
    return np.random.default_rng(seed).integers(0, 256, (n, *hw, 3), dtype=np.uint8)


def _hold(got, ref, box_rtol=1e-4, box_atol=1e-2, score_rtol=1e-4, score_atol=1e-5):
    assert int(ref.num_valid.sum()) > 0
    np.testing.assert_array_equal(got.num_valid, ref.num_valid)
    np.testing.assert_array_equal(got.class_ids, ref.class_ids)
    np.testing.assert_allclose(got.boxes_xyxy, ref.boxes_xyxy, rtol=box_rtol, atol=box_atol)
    np.testing.assert_allclose(got.scores, ref.scores, rtol=score_rtol, atol=score_atol)


def test_mesh_shape(mesh):
    assert mesh.shape == {"dp": 4, "tp": 2}
    assert make_mesh(4, devices=CPU8).shape == {"dp": 2, "tp": 2}
    assert batch_sharding(mesh, 4).spec == ("dp", None, None, None)


def test_param_shardings_channel_rule(mesh, tree):
    """The channel rule on the JAX-layout tree, leaf for leaf the JAX
    package's ``param_shardings`` on the same tree."""
    from realtime_analytics_tpu.parallel.mesh import make_mesh as j_make_mesh
    from realtime_analytics_tpu.parallel.mesh import param_shardings as j_shardings

    mine = jax.tree_util.tree_leaves(param_shardings(tree, mesh),
                                     is_leaf=lambda x: hasattr(x, "spec"))
    theirs = jax.tree_util.tree_leaves(j_shardings(tree, j_make_mesh(8)))
    assert len(mine) == len(theirs)
    n_sharded = 0
    for leaf, a, b in zip(jax.tree_util.tree_leaves(tree), mine, theirs):
        assert tuple(a.spec) == tuple(b.spec)
        if leaf.shape and leaf.shape[-1] % 2 == 0:
            assert a.spec[-1] == "tp"
            n_sharded += 1
    assert n_sharded > 50  # most conv kernels are sharded


def test_shard_params_places_slices(mesh, tree):
    placed = shard_params(tree, mesh)
    w = placed["layers"]["0"]["w"]  # [3, 3, 3, 16]: cout over tp
    assert w.spec == (None, None, None, "tp") and w.pieces.shape == (4, 2)
    assert tuple(w.pieces[1, 1].shape) == (3, 3, 3, 8)
    np.testing.assert_array_equal(w.full().numpy(), tree["layers"]["0"]["w"])


def test_v5_anchors_replicated_not_sharded(mesh):
    tree5 = params_to_tree(build_yolo("yolov5", "n", 16))
    assert param_shardings(tree5, mesh)["layers"]["24"]["anchors"].spec == ()


def test_make_mesh_insufficient_devices_is_actionable():
    if torch.cuda.device_count() >= 16:
        pytest.skip("sixteen cards are visible")
    with pytest.raises(ValueError, match=r"devices=\[torch.device\('cpu'\)\] \* 16"):
        make_mesh(16)
    with pytest.raises(ValueError, match="names 2"):
        make_mesh(4, devices=CPU8[:2])


def test_anchor_centers_layout():
    a = anchor_centers((64, 64))
    assert a.shape == ((8 * 8) + (4 * 4) + (2 * 2), 2)
    np.testing.assert_allclose(a[0], [4.0, 4.0])
    np.testing.assert_allclose(a[64], [8.0, 8.0])


def _train_inputs(batch=8, nc=8):
    rng = np.random.default_rng(0)
    images = rng.uniform(0, 1, (batch, 64, 64, 3)).astype(np.float32)
    return images, synthetic_targets(rng, batch, 4, (64, 64), nc)


def test_sharded_train_step_decreases_loss(mesh):
    # lr 1e-3: at JAX's 5e-3 the port's seeded init spikes at step 3, on one
    # device as over the mesh (the same losses to 1e-4)
    model = build_yolo("yolov8", "n", nc=8)
    init_fn, step_fn = make_train_step(model, (64, 64), learning_rate=1e-3, mesh=mesh)
    state = init_fn(0)
    images, targets = _train_inputs()
    losses = []
    for _ in range(5):
        state, loss = step_fn(state, images, targets)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    # the parameters and their moments are sharded: tp slices of each conv
    w = state.params["layers.1.parts.1.weight"]
    assert w.shape[0] == model.layers["1"].weight.shape[0] // 2
    assert state.opt_state.state[w]["exp_avg"].shape == w.shape
    # and the model's own tensors hold the joined parameters
    torch.testing.assert_close(model.layers["1"].weight[w.shape[0]:], w, rtol=0, atol=0)


def test_sharded_train_loss_is_the_global_batch_loss(mesh):
    """The loss under (4, 2) is one device's loss on the whole batch (not
    a mean of per-shard means), at every one of three steps."""
    images, targets = _train_inputs()
    runs = []
    for kw in (dict(device="cpu"), dict(mesh=mesh)):
        model = build_yolo("yolov8", "n", nc=8)
        init_fn, step_fn = make_train_step(model, (64, 64), learning_rate=1e-3, **kw)
        state = init_fn(0)
        losses = []
        for _ in range(3):
            state, loss = step_fn(state, images, targets)
            losses.append(float(loss))
        runs.append(losses)
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)


def test_sharded_train_step_on_distinct_devices():
    """Rows on other devices than row 0's run through ``functional_call``
    on copies of the parameters; their gradients reach row 0's tensors
    (``cpu`` and ``cpu:0`` are two device names of one memory)."""
    mesh = make_mesh(4, shape=(2, 2), devices=["cpu", "cpu", "cpu:0", "cpu:0"])
    images, targets = _train_inputs(4)
    runs = []
    for kw in (dict(device="cpu"), dict(mesh=mesh)):
        model = build_yolo("yolov8", "n", nc=8)
        init_fn, step_fn = make_train_step(model, (64, 64), learning_rate=1e-3, **kw)
        state = init_fn(0)
        for _ in range(2):
            state, loss = step_fn(state, images, targets)
        runs.append(float(loss))
    assert state.net._direct == [True, False]
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-5)


def test_make_train_step_rejects_v5(mesh):
    with pytest.raises(ValueError, match="yolov8"):
        make_train_step(build_yolo("yolov5", "n", nc=16), (64, 64), mesh=mesh)


@pytest.mark.parametrize("model_type", ["yolov8", "yolov5"])
def test_sharded_inference_matches_single_device(mesh, model_type):
    """The model over (4, 2) and over (1, 8) equals it on one device (the
    v5 head reads its convs' joined weights)."""
    from realtime_analytics_tpu_torch.models.weights import params_from_jax

    model = build_yolo(model_type, "n", 16)
    params_from_jax(model, synthetic_params(model, seed=0)).eval().to(
        memory_format=torch.channels_last)
    model.prepare_neck()
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (8, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        ref = model(x, reduce_scores=True)
        for m in (mesh, make_mesh(8, shape=(1, 8), devices=CPU8)):
            got = ShardedModel(model, m)(x, reduce_scores=True)
            for k in ref:
                np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-3)


def test_engine_mesh_shape_config_is_wired(tree):
    base = dict(host_select="off")
    plain = TorchYoloEngine(_cfg(**base), params=tree)
    sharded = TorchYoloEngine(_cfg(mesh_shape=[4, 2], **base), params=tree)
    assert sharded.mesh is not None and sharded.mesh.shape == {"dp": 4, "tp": 2}
    names = [n for n, _ in sharded.sharded.named_parameters()]
    assert "layers.0.parts.1.weight" in names
    frames = _frames(2)
    _hold(sharded.predict_arrays(frames), plain.predict_arrays(frames))


def _steps_run(eng, monkeypatch):
    """The (bucket, source, selected) of every step ``eng`` runs."""
    runs, real = [], eng._run_bucket
    monkeypatch.setattr(eng, "_run_bucket", lambda b, f, hw, sel: runs.append(
        (b, tuple(hw), sel)) or real(b, f, hw, sel))
    return runs


def test_engine_mesh_small_batches_round_to_dp(tree, monkeypatch):
    eng = TorchYoloEngine(_cfg(batch_buckets=[1, 2, 8], host_select="off",
                               mesh_shape=[4, 2]), params=tree)
    assert eng._effective_bucket(1, HW) == 4
    runs = _steps_run(eng, monkeypatch)
    br = eng.predict_arrays(_frames(3, n=1))
    assert br.boxes_xyxy.shape[0] == 1 and runs == [(4, HW, False)]


def test_engine_mesh_warmup_primes_the_served_step(tree, monkeypatch):
    """Warmup runs each bucket rounded to dp: the step predict then runs."""
    eng = TorchYoloEngine(_cfg(batch_buckets=[2, 8], host_select="off", mesh_shape=[4, 2]),
                          params=tree)
    runs = _steps_run(eng, monkeypatch)
    eng.warmup(HW)
    assert set(eng._bucket_cost_ms[HW]) == {2, 8}
    primed = set(runs)
    assert primed == {(4, HW, False), (8, HW, False)}
    runs.clear()
    eng.predict_arrays(_frames(3, n=2))
    eng.predict_arrays(_frames(4, n=8))
    assert set(runs) <= primed and len(runs) == 2


def test_engine_mesh_keeps_the_gather_kernel(tree, monkeypatch):
    """B1' runs once per dp shard (two gathers a step: 8 calls at dp 4) and
    serves what ``torch.gather`` serves, bit for bit."""
    from realtime_analytics_tpu_torch.ops import gather

    base = dict(host_select="off", mesh_shape=[4, 2])
    torch_gather = TorchYoloEngine(_cfg(pallas_gather="off", **base), params=tree)
    kernel = TorchYoloEngine(_cfg(pallas_gather="on", **base), params=tree)
    frames = _frames(5)
    ref = torch_gather.predict_arrays(frames)
    calls = []
    plain = gather.row_gather_plain
    monkeypatch.setattr(gather, "row_gather_plain",
                        lambda p, i: calls.append(p.shape[0]) or plain(p, i))
    got = kernel.predict_arrays(frames)
    assert calls == [2] * 8
    assert int(ref.num_valid.sum()) > 0
    for field in ("num_valid", "class_ids", "boxes_xyxy", "scores"):
        np.testing.assert_array_equal(getattr(got, field), getattr(ref, field))


def test_row_gather_per_shard_is_bit_equal(mesh):
    from realtime_analytics_tpu_torch.ops.gather import row_gather

    rng = np.random.default_rng(7)
    payload = torch.from_numpy(rng.standard_normal((8, 300, 6)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, 300, (8, 50)))
    want = row_gather(payload, idx)
    got = row_gather(payload, idx, mesh)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not split over dp=4"):
        dp_map(row_gather, mesh, payload[:6], idx[:6])


def test_engine_mesh_letterbox_per_shard(tree, monkeypatch):
    """B4' (the letterbox wrapper, its plain version on the CPU) once per dp
    shard on the device-resize step, against the plain resize."""
    from realtime_analytics_tpu_torch.ops import letterbox

    base = dict(host_select="off", host_resize="off", mesh_shape=[4, 2])
    plain = TorchYoloEngine(_cfg(pallas_preprocess="off", **base), params=tree)
    kernel = TorchYoloEngine(_cfg(pallas_preprocess="on", **base), params=tree)
    frames = _frames(6, hw=(100, 150))  # a fractional ratio: the resize path
    ref = plain.predict_arrays(frames)
    calls = []
    real = letterbox.letterbox_plain
    monkeypatch.setattr(letterbox, "letterbox_plain",
                        lambda f, *a: calls.append(f.shape[0]) or real(f, *a))
    got = kernel.predict_arrays(frames)
    assert calls == [2] * 4
    _hold(got, ref, box_rtol=1e-2, box_atol=1.0, score_rtol=5e-2, score_atol=5e-3)


def test_sharded_engine_matches_jax_sharded_engine(tree):
    """The port's (4, 2) engine and the JAX package's (4, 2) engine on the
    same params and frames."""
    from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
    from realtime_analytics_tpu.engine.detector import JaxYoloEngine

    kw = dict(model_path="__random__.pt", input_size=[64, 64], confidence_threshold=0.25,
              max_batch_size=8, batch_buckets=[8], precision="fp32", warmup=False,
              pre_nms_topk=64, max_detections=16, num_classes=16, host_select="off",
              mesh_shape=[4, 2])
    jax_eng = JaxYoloEngine(JaxConfig(**kw), params=tree)
    port = TorchYoloEngine(DetectorConfig(device="cpu", **kw), params=tree)
    assert len(jax.tree_util.tree_leaves(jax_eng.params)[5].sharding.device_set) > 1
    frames = _frames(9)
    _hold(port.predict_arrays(frames), jax_eng.predict_arrays(frames),
          box_rtol=0, box_atol=1e-2, score_rtol=0, score_atol=1e-4)


def test_resnet_mesh_engine_matches_one_device():
    kw = dict(model_type="resnet", model_path="resnet18-seeded.pt", host_resize="off",
              resnet_top_k=5)
    one = TorchResNetEngine(_cfg(**kw))
    sharded = TorchResNetEngine(_cfg(mesh_shape=[4, 2], **kw))
    assert "fc.parts.1.weight" in dict(sharded.sharded.named_parameters())
    frames = _frames(10)
    (s1, c1), (s8, c8) = one.classify(frames), sharded.classify(frames)
    np.testing.assert_array_equal(c8, c1)
    np.testing.assert_allclose(s8, s1, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("model_type", ["cnn_lstm", "conv_gru"])
def test_temporal_mesh_engine_matches_one_device(model_type):
    """The clip batch over dp; convs and dense layers over tp (ConvGRU's
    gates read their joined weights, the LSTM keeps replicated ones)."""
    from realtime_analytics_tpu_torch.config import StreamConfig
    from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
    from realtime_analytics_tpu_torch.types import FramePacket

    kw = dict(model_type=model_type, host_resize="off", sequence_length=2,
              batch_buckets=[1, 4], max_batch_size=4)
    one = TorchTemporalEngine(_cfg(**kw))
    sharded = TorchTemporalEngine(_cfg(mesh_shape=[2, 2], **kw))
    assert sharded._round_mesh(1) == 2
    frames = _frames(11, n=6)
    seqs = [[FramePacket(stream=StreamConfig(name=f"s{j}"), frame=frames[j + i],
                         frame_id=i, timestamp=0.0) for i in range(2)] for j in range(3)]
    a, b = one.predict_clips(seqs), sharded.predict_clips(seqs)
    assert len(a) == len(b) == 3
    for da, db in zip(a, b):
        assert [d.class_id for d in db] == [d.class_id for d in da]
        np.testing.assert_allclose([d.confidence for d in db], [d.confidence for d in da],
                                   rtol=1e-4, atol=1e-5)


def test_dryrun_multichip():
    from realtime_analytics_tpu_torch.parallel.dryrun import dryrun_multichip

    out = dryrun_multichip(8, CPU8)  # 8 entries: the three-axis mesh, as JAX's
    assert out["mesh"] == {"dp": 2, "sp": 2, "tp": 2} and out["batch"] == 4
    assert all(np.isfinite(out["train_loss"])) and out["detections"] > 0
    assert out["halo_copies"] > 0


@pytest.mark.parametrize("model_type", ["resnet", "cnn_lstm"])
def test_mesh_engine_matches_jax_mesh_engine(model_type):
    """The port's ResNet and temporal engines over (4, 2) against the JAX
    package's over its 8-device mesh, on the same params (JAX's init,
    carried across) and frames: classes equal, confidences within 1e-5 (as
    tests/test_torch_export_jax.py holds the two packages' engines)."""
    from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
    from realtime_analytics_tpu.config import StreamConfig as JaxStream
    from realtime_analytics_tpu.types import FramePacket as JaxPacket
    from realtime_analytics_tpu_torch.config import StreamConfig
    from realtime_analytics_tpu_torch.engine.temporal import TorchTemporalEngine
    from realtime_analytics_tpu_torch.types import FramePacket

    kw = dict(device="cpu", precision="fp32", warmup=False, confidence_threshold=1e-6,
              batch_buckets=[8], max_batch_size=8, host_resize="off", mesh_shape=[4, 2])
    if model_type == "resnet":
        from realtime_analytics_tpu.engine.detector import JaxResNetEngine as JaxEngine
        from realtime_analytics_tpu.models.resnet import build_resnet

        model, port_engine = build_resnet("resnet18", 10), TorchResNetEngine
        kw.update(model_path="resnet18-seeded", model_type="resnet", input_size=[64, 64],
                  resnet_num_classes=10, resnet_top_k=5, resnet_scores="softmax")
    else:
        from realtime_analytics_tpu.engine.temporal import JaxTemporalEngine as JaxEngine
        from realtime_analytics_tpu.models.temporal import build_temporal

        model, port_engine = build_temporal(model_type, 12, "avg"), TorchTemporalEngine
        kw.update(model_path="absent-temporal.npz", model_type=model_type,
                  input_size=[32, 32], num_action_classes=12, sequence_length=4,
                  sequence_stride=1, temporal_overlap=0.5)
    params = jax.tree_util.tree_map(np.asarray, model.init_params(jax.random.PRNGKey(0)))
    want_eng = JaxEngine(JaxConfig(**{k: v for k, v in kw.items() if k != "device"}),
                         params=params)
    got_eng = port_engine(DetectorConfig(**kw), params=params)
    assert want_eng.mesh is not None and got_eng.mesh.shape == {"dp": 4, "tp": 2}
    frames = _frames(12, n=8, hw=(60, 80))

    def packets(jax_side, idx):
        stream = (JaxStream if jax_side else StreamConfig)(name="cam", url="x")
        packet = JaxPacket if jax_side else FramePacket
        return [packet(stream=stream, frame=frames[i], frame_id=i, timestamp=0.0)
                for i in idx]

    if model_type == "resnet":
        want = want_eng.predict_packets(packets(True, range(8)))
        got = got_eng.predict_packets(packets(False, range(8)))
    else:
        clips = [range(j, j + 4) for j in range(3)]
        want = want_eng.predict_clips([packets(True, c) for c in clips])
        got = got_eng.predict_clips([packets(False, c) for c in clips])
    assert len(got) == len(want)
    for w, g in zip(want, got):
        assert len(g) > 0 and [d.class_id for d in g] == [d.class_id for d in w]
        np.testing.assert_allclose([d.confidence for d in g], [d.confidence for d in w],
                                   atol=1e-5, rtol=0)


# -- the sp axis ------------------------------------------------------------


@pytest.fixture(scope="module")
def mesh3():
    """The three-axis (dp, sp, tp) mesh the dry run takes at n = 8."""
    return make_mesh(8, axis_names=AXES_SP, devices=CPU8)


def test_mesh3_shape(mesh3):
    assert mesh3.shape == {"dp": 2, "sp": 2, "tp": 2}
    assert mesh3.grid.shape == (2, 2, 2)
    placed = shard_params(params_to_tree(build_yolo("yolov8", "n", 8)), mesh3)
    assert placed["layers"]["0"]["w"].pieces.shape == (2, 2, 2)
    with pytest.raises(ValueError, match="must name the axes"):
        make_mesh(8, axis_names=("dp", "tp", "sp"), devices=CPU8)


def test_sharded_train_step_3axis_sp_halo(mesh3):
    """The train step on (2, 2, 2): images split over dp and by height over
    sp, the loss lowered over 3 steps, gradients reaching row 0's tensors
    through the halo copies."""
    model = build_yolo("yolov8", "n", nc=8)
    init_fn, step_fn = make_train_step(model, (64, 64), learning_rate=1e-3, mesh=mesh3)
    state = init_fn(0)
    images, targets = _train_inputs(4)
    losses = []
    for _ in range(3):
        state, loss = step_fn(state, images, targets)
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], f"loss did not decrease: {losses}"
    assert state.net.halo_copies > 0
    w = state.params["layers.1.parts.1.weight"]
    torch.testing.assert_close(model.layers["1"].weight[w.shape[0]:], w, rtol=0, atol=0)


def test_sp_train_loss_is_the_one_device_loss(mesh3):
    """The loss under (2, 2, 2) is one device's on the whole batch, within
    1e-6 relative, at every one of three steps; also with rows and ranks on
    two device names of one memory (the copies through ``.to``)."""
    images, targets = _train_inputs(4)
    runs = []
    for kw in (dict(device="cpu"), dict(mesh=mesh3),
               dict(mesh=make_mesh(8, axis_names=AXES_SP, devices=["cpu", "cpu:0"] * 4))):
        model = build_yolo("yolov8", "n", nc=8)
        init_fn, step_fn = make_train_step(model, (64, 64), learning_rate=1e-3, **kw)
        state = init_fn(0)
        losses = []
        for _ in range(3):
            state, loss = step_fn(state, images, targets)
            losses.append(float(loss))
        runs.append(losses)
    np.testing.assert_allclose(runs[1], runs[0], rtol=1e-6)
    np.testing.assert_allclose(runs[2], runs[0], rtol=1e-6)


@pytest.mark.parametrize("model_type", ["yolov8", "yolov5"])
def test_sharded_inference_3axis_matches_single_device(mesh3, model_type):
    """dp + sp (+ tp) sharded inference equals one device, the fused neck's
    split 1x1s included; at sp 4 P5 (2 rows) leaves two ranks empty."""
    from realtime_analytics_tpu_torch.models.weights import params_from_jax

    model = build_yolo(model_type, "n", 16)
    params_from_jax(model, synthetic_params(model, seed=0)).eval().to(
        memory_format=torch.channels_last)
    model.prepare_neck()
    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (4, 64, 64, 3))
                         .astype(np.float32))
    with torch.inference_mode():
        ref = model(x, reduce_scores=True)
        for m in (mesh3, make_mesh(8, shape=(1, 4, 2), axis_names=AXES_SP, devices=CPU8)):
            net = ShardedModel(model, m)
            got = net(x, reduce_scores=True)
            assert net.halo_copies > 0
            for k in ref:
                np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-4, atol=1e-3)


def _banded_case(op, sp, gen):
    from realtime_analytics_tpu_torch.models.layers import ConvAct
    from realtime_analytics_tpu_torch.models.yolo import SPPF

    def conv(cin, cout, k, s=1, p=None):
        mod = ConvAct(cin, cout, k, s, p)
        with torch.no_grad():
            mod.weight.normal_(0, 0.3, generator=gen)
            mod.bias.normal_(0, 0.1, generator=gen)
        return mod

    def t(*shape):
        return torch.randn(shape, generator=gen).contiguous(memory_format=torch.channels_last)

    skip = None
    if op == "k1s1":
        mod, x = conv(6, 8, 1), t(2, 6, 13, 9)
    elif op == "k3s1":
        mod, x = conv(6, 8, 3), t(2, 6, 13, 9)
    elif op == "k3s2":
        mod, x = conv(6, 8, 3, 2), t(2, 6, 13, 9)
    elif op == "k6s2p2":
        mod, x = conv(3, 8, 6, 2, 2), t(2, 3, 17, 10)
    elif op == "sppf":
        mod = SPPF(8, 8, 5)
        with torch.no_grad():
            for c in (mod.cv1, mod.cv2):
                c.weight.normal_(0, 0.3, generator=gen)
                c.bias.normal_(0, 0.1, generator=gen)
        x = t(2, 8, 2 if sp > 2 else 5, 6)
    else:  # the fused neck's split 1x1 over concat(up2x(x), skip)
        mod, x, skip = conv(10, 8, 1), t(2, 6, 5, 4), t(2, 4, 10, 8)
        if op == "up_concat_split":
            mod.split_input(6)
    return mod, x, skip


@pytest.mark.parametrize("sp", [2, 3, 4])
@pytest.mark.parametrize("op", ["k1s1", "k3s1", "k3s2", "k6s2p2", "sppf", "up_concat",
                                "up_concat_split"])
def test_banded_op_matches_whole(op, sp):
    """One op over ``sp`` uneven bands, joined, equals the whole op."""
    from realtime_analytics_tpu_torch.parallel.spatial import _Walk, band_rows

    mod, x, skip = _banded_case(op, sp, torch.Generator().manual_seed(sp))
    walk = _Walk(np.array([[x.device]] * sp, dtype=object))

    def bands(t):
        return [t[:, :, lo:hi] for lo, hi in band_rows(t.shape[2], sp)]

    with torch.no_grad():
        if op.startswith("up_concat"):
            want, out = mod.up_concat(x, skip), walk.up_concat(mod, bands(x), bands(skip))
        elif op == "sppf":
            want, out = mod(x), walk.sppf(mod, bands(x))
        else:
            want, out = mod(x), walk.conv(mod, bands(x))
    got, copies = walk.join(out), walk.copies
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert len({hi - lo for lo, hi in band_rows(x.shape[2], sp)}) > 1  # uneven bands
    assert (copies > 0) == (op not in ("k1s1",))


def test_engine_3axis_step_matches_one_device_and_jax(tree):
    """The engine's step with its model over (2, 2, 2) through ``use_mesh``
    (the hook ``_init_mesh`` uses; no config key names sp, as in JAX): equal
    to one device's, and to the JAX package's three-axis sharded step (its
    params over the mesh, frames over dp and sp;
    tests/test_parallel.py:123-148) on the same params and frames."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from realtime_analytics_tpu.config import DetectorConfig as JaxConfig
    from realtime_analytics_tpu.engine.detector import JaxYoloEngine
    from realtime_analytics_tpu.parallel.mesh import make_mesh as j_make_mesh
    from realtime_analytics_tpu.parallel.mesh import shard_params as j_shard_params

    kw = dict(model_path="__random__.pt", input_size=[64, 64], confidence_threshold=0.01,
              max_batch_size=4, batch_buckets=[4], precision="fp32", warmup=False,
              pre_nms_topk=64, max_detections=16, num_classes=16, host_select="off")
    one = TorchYoloEngine(DetectorConfig(device="cpu", **kw), params=tree)
    eng = TorchYoloEngine(DetectorConfig(device="cpu", **kw), params=tree)
    eng.use_mesh(make_mesh(8, axis_names=AXES_SP, devices=CPU8))
    assert eng.mesh.shape == {"dp": 2, "sp": 2, "tp": 2} and eng.model.pallas_stem == "off"
    frames = _frames(13, n=4)
    got = eng.predict_arrays(frames)
    assert eng.sharded.halo_copies > 0
    _hold(got, one.predict_arrays(frames))

    jeng = JaxYoloEngine(JaxConfig(**kw), params=tree)
    mesh3 = j_make_mesh(8, axis_names=("dp", "sp", "tp"))
    step = jeng._get_step(4, HW)
    with mesh3:
        fsh = jax.device_put(frames, NamedSharding(mesh3, P("dp", "sp", None, None)))
        b, s, c, n = (np.asarray(v) for v in jax.device_get(
            step(j_shard_params(jeng.params, mesh3), fsh)))
    from realtime_analytics_tpu_torch.types import BatchResult

    _hold(got, BatchResult(boxes_xyxy=b, scores=s, class_ids=c, num_valid=n),
          box_rtol=0, box_atol=1e-2, score_rtol=0, score_atol=1e-4)


def test_sp_mesh_refuses_s2d_and_int8_by_name(tree):
    """s2d under an sp axis is reached by no JAX entry point, and the int8
    conv has no banded form: both refused by name (ROADMAP.md "Held")."""
    kw = dict(host_select="off", batch_buckets=[4], max_batch_size=4)
    eng = TorchYoloEngine(_cfg(s2d_backbone="on", **kw), params=tree)
    eng.use_mesh(make_mesh(8, axis_names=AXES_SP, devices=CPU8))
    with pytest.raises(ValueError, match="s2d_backbone under an sp mesh axis"):
        eng.predict_arrays(_frames(14, n=4))
    int8 = TorchYoloEngine(_cfg(precision="int8", **kw), params=tree)
    with pytest.raises(ValueError, match="int8 weights under an sp mesh axis"):
        int8.use_mesh(make_mesh(8, axis_names=AXES_SP, devices=CPU8))
