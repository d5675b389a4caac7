"""The port's train step (``parallel/train.py``) against the JAX package's.

YOLOv8n, nc = 4, 64², batch 2: JAX's ``init_params(PRNGKey(0))`` carried
across with ``params_from_jax``, images and targets made with numpy. The
JAX loss and gradients come from one jitted ``value_and_grad`` a module.
Bounds: loss rtol 1e-5; every gradient leaf within a relative L2 of 1e-4
(the JAX forward fuses the neck, the port's train step does not: equal up
to reduction order; tests/test_torch_neck_fusion.py holds the fused
one). AdamW against ``optax.adamw`` on identical gradients for 3 steps:
params and moments within 1e-6 absolute. A whole step's parameters are not
compared elementwise: at step 1 Adam moves each weight by about ±lr
whatever its gradient's size, so sign noise on near-zero gradients flips
updates; gradients and the optimizer are held apart instead.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from realtime_analytics_tpu.models.yolo import build_yolo as j_build
from realtime_analytics_tpu.parallel import train as jtrain
from realtime_analytics_tpu_torch.models.weights import params_from_jax, params_to_tree
from realtime_analytics_tpu_torch.models.yolo import build_yolo
from realtime_analytics_tpu_torch.parallel import train

HW = (64, 64)
NC = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: training trajectories are chaotic in their
    rounding and the thread count changes it, so one thread gives the same
    run on every machine, and the test workers do not oversubscribe the
    cores (several training processes of 8 threads each on 8 cores slow
    down up to 100-fold)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jax_side():
    """JAX's model, its init tree (numpy) and one jitted value_and_grad."""
    jm = j_build("yolov8", "n", nc=NC)
    jparams = jm.init_params(jax.random.PRNGKey(0))
    anchors = jnp.asarray(jtrain.anchor_centers(HW))
    vg = jax.jit(jax.value_and_grad(
        lambda p, im, tg: jtrain.detection_loss(jm, p, im, tg, anchors)))
    return jparams, jax.tree_util.tree_map(np.asarray, jparams), vg


def _inputs(seed):
    rng = np.random.default_rng(seed)
    images = rng.uniform(0, 1, (2, *HW, 3)).astype(np.float32)
    return images, jtrain.synthetic_targets(rng, 2, 4, HW, NC)


def _port_loss_and_grads(tree, images, targets):
    model = params_from_jax(build_yolo("yolov8", "n", NC), tree)
    train.make_train_step(model, HW, device="cpu")  # to the CPU, fp32, taking gradients
    anchors = torch.from_numpy(train.anchor_centers(HW))
    tg = {k: torch.from_numpy(np.asarray(v)) for k, v in targets.items()}
    loss = train.detection_loss(model, torch.from_numpy(images), tg, anchors)
    loss.backward()
    loss = loss.detach()
    grads = train.named_tree(model, {n: p.grad for n, p in model.named_parameters()})
    return float(loss), grads


def _hold_grads(got, want, rel_l2):
    leaves_got = jax.tree_util.tree_leaves(got)
    leaves_want = jax.tree_util.tree_leaves(want)
    assert len(leaves_got) == len(leaves_want) > 100
    worst = 0.0
    for g, w in zip(leaves_got, leaves_want):
        w = np.asarray(w)
        assert g.shape == w.shape
        err = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        worst = max(worst, err)
    assert worst <= rel_l2, worst
    return worst


def test_anchor_centers_and_synthetic_targets_equal_jax():
    for hw in ((64, 64), (640, 640), (96, 160)):
        np.testing.assert_array_equal(train.anchor_centers(hw), jtrain.anchor_centers(hw))
    got = train.synthetic_targets(np.random.default_rng(5), 3, 7, (640, 480), 80)
    want = jtrain.synthetic_targets(np.random.default_rng(5), 3, 7, (640, 480), 80)
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(jax_side, seed):
    jparams, tree, vg = jax_side
    images, targets = _inputs(seed)
    want_loss, want_grads = vg(jparams, jnp.asarray(images),
                               {k: jnp.asarray(v) for k, v in targets.items()})
    loss, grads = _port_loss_and_grads(tree, images, targets)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    _hold_grads(grads, jax.tree_util.tree_map(np.asarray, want_grads), 1e-4)


def test_max_scatter_two_targets_on_one_anchor_and_a_masked_one(jax_side):
    """Targets 0 and 1 share a center (one anchor) and a class: JAX's
    .at[].max leaves that one-hot at 1 where an add would make it 2. Target
    2 is masked on the same anchor and class, target 3 masked elsewhere."""
    jparams, tree, vg = jax_side
    images, _ = _inputs(2)
    box = [10.0, 12.0, 30.0, 28.0]
    targets = {
        "boxes": np.array([[box, [12.0, 14.0, 28.0, 26.0], box, [40.0, 40.0, 60.0, 62.0]],
                           [box, box, [1.0, 1.0, 9.0, 9.0], [33.0, 5.0, 47.0, 19.0]]],
                          np.float32),
        "classes": np.array([[2, 2, 2, 1], [0, 0, 3, 3]], np.int32),
        "mask": np.array([[True, True, False, False], [True, True, True, False]]),
    }
    anchors = torch.from_numpy(train.anchor_centers(HW))
    centers = (targets["boxes"][..., :2] + targets["boxes"][..., 2:]) / 2
    d2 = ((torch.from_numpy(centers)[:, :, None] - anchors) ** 2).sum(-1)
    assigned = torch.argmin(d2, -1)
    assert assigned[0, 0] == assigned[0, 1] == assigned[0, 2]  # one anchor, one class
    want_loss, want_grads = vg(jparams, jnp.asarray(images),
                               {k: jnp.asarray(v) for k, v in targets.items()})
    loss, grads = _port_loss_and_grads(tree, images, targets)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-5)
    _hold_grads(grads, jax.tree_util.tree_map(np.asarray, want_grads), 1e-4)


def test_adamw_matches_optax_over_three_steps(jax_side):
    jparams, tree, _ = jax_side
    lr = 2e-3
    tx = optax.adamw(lr)
    update = jax.jit(tx.update)
    apply = jax.jit(optax.apply_updates)
    jp = jparams
    jstate = tx.init(jp)
    model = params_from_jax(build_yolo("yolov8", "n", NC), tree)
    train.make_train_step(model, HW, device="cpu")
    opt = train.make_optimizer(model, lr)
    rng = np.random.default_rng(11)
    for _ in range(3):
        gtree = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), tree)
        updates, jstate = update(jax.tree_util.tree_map(jnp.asarray, gtree), jstate, jp)
        jp = apply(jp, updates)
        for name, p in model.named_parameters():
            node, leaf = train._node(gtree, name)
            p.grad = train._from_tree_layout(node[leaf], p, name)
        opt.step()
    adam = jstate[0]
    got = train.opt_state_tree(model, opt)
    assert got["count"] == int(adam.count) == 3
    for mine, theirs in ((params_to_tree(model), jp), (got["mu"], adam.mu),
                         (got["nu"], adam.nu)):
        for g, w in zip(jax.tree_util.tree_leaves(mine), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


def test_opt_state_round_trips_through_its_tree(jax_side):
    _, tree, _ = jax_side
    model = params_from_jax(build_yolo("yolov8", "n", NC), tree)
    init_fn, step_fn = train.make_train_step(model, HW, device="cpu")
    state = init_fn(0)
    images, targets = _inputs(3)
    state, _ = step_fn(state, images, targets)
    saved = train.opt_state_tree(model, state.opt_state)
    fresh = train.make_optimizer(model, 1e-3)
    train.load_opt_state_tree(model, fresh, saved)
    again = train.opt_state_tree(model, fresh)
    assert again["count"] == saved["count"] == 1
    for a, b in zip(jax.tree_util.tree_leaves(again), jax.tree_util.tree_leaves(saved)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        train.load_opt_state_tree(model, fresh, {"count": 1, "mu": saved["mu"]})


def test_v5_is_refused():
    with pytest.raises(ValueError, match="supports yolov8"):
        train.make_train_step(build_yolo("yolov5", "n", NC), HW, device="cpu")


def test_trainer_model_runs_plain_and_takes_gradients():
    model = build_yolo("yolov8", "n", NC)
    model.pallas_stem = model.pallas_decode = "on"
    init_fn, step_fn = train.make_train_step(model, HW, learning_rate=1e-3, device="cpu")
    assert model.pallas_stem == "off" and model.pallas_decode == "off"
    state = init_fn(0)
    assert all(p.requires_grad for p in model.parameters())
    before = {n: p.detach().clone() for n, p in state.params.items()}
    images, targets = _inputs(4)
    state, loss = step_fn(state, images, targets)
    assert state.step == 1 and loss.dim() == 0 and torch.isfinite(loss)
    assert all(p.grad is not None for p in model.parameters())
    # every parameter with a gradient or a value to decay moved (at 64² no
    # target falls on P5, so its box branch's zero biases stay zero)
    moved = [not torch.equal(before[n], p) for n, p in state.params.items()
             if p.grad.any() or before[n].any()]
    assert len(moved) > 100 and all(moved)
