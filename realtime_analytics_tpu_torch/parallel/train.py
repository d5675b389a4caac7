"""Detection training step on one device.

Counterpart of ``realtime_analytics_tpu/parallel/train.py``: forward, the
same anchor-free detection loss, backward and an AdamW update (optax's
``adamw`` defaults), here on one card (or the CPU) instead of jit'd over a
(dp, tp) mesh (multi-device training waits for ROADMAP.md Queue A item 7).

The loss, as the JAX package's:

  * assignment: each ground-truth box is assigned to the anchor whose cell
    center is nearest its center (one-to-one, static shapes);
  * classification: binary cross-entropy over all anchors against the
    scattered one-hot targets (background = all-zeros);
  * box regression: (1 - IoU) at assigned anchors.

Gradients follow JAX's: every clamp of the loss is ``torch.maximum`` /
``torch.minimum`` against a tensor, which splits the gradient of a tie in
two as JAX's ``maximum`` does (``clamp`` passes it whole). The model runs
its plain path (``pallas_stem`` and ``pallas_decode`` "off"): the kernels
B2 and B3 have no backward, and JAX's training does not run them either.
On the card the step's convolutions are true fp32 (cuDNN's TF32 off for
the step's duration) and its kernels deterministic: the recipe of the
train CLI is chaotic in its rounding (a last-bit difference early on
decides whether a 400-step run converges or spikes), so a run is only
reproducible when every step rounds the same way.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from ..models.weights import params_to_tree
from ..models.yolo import STRIDES, YoloModel

_EPS = 1e-7

BETAS = (0.9, 0.999)  # optax.adamw's defaults
ADAM_EPS = 1e-8
WEIGHT_DECAY = 1e-4  # optax's default (torch's is 1e-2); biases decay too


def anchor_centers(input_hw: Tuple[int, int]) -> np.ndarray:
    """Static anchor cell centers [A, 2] (x, y) in input pixels (v8 layout)."""
    h, w = input_hw
    out = []
    for s in STRIDES:
        gh, gw = h // s, w // s
        ys, xs = np.meshgrid(np.arange(gh), np.arange(gw), indexing="ij")
        cx = (xs.reshape(-1) + 0.5) * s
        cy = (ys.reshape(-1) + 0.5) * s
        out.append(np.stack([cx, cy], axis=-1))
    return np.concatenate(out, axis=0).astype(np.float32)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``ops/boxes.iou_matrix`` with JAX's gradient at ties: the clamps are
    ``torch.maximum`` against a zero-dim tensor. The forward values are the
    same; serving keeps ``clamp_min``, which computes no gradient and needs
    no tensor for its bound on the card."""
    zero, floor = a.new_zeros(()), a.new_full((), 1e-6)
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = torch.maximum(br - tl, zero)
    inter = wh[..., 0] * wh[..., 1]
    da = a[..., 2:4] - a[..., :2]
    db = b[..., 2:4] - b[..., :2]
    area_a = da[..., 0] * da[..., 1]
    area_b = db[..., 0] * db[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.maximum(union, floor)


def detection_loss(
    model: YoloModel,
    images: torch.Tensor,  # [N, H, W, 3] normalized RGB
    targets: Dict[str, torch.Tensor],  # boxes [N,M,4] xyxy px, classes [N,M], mask [N,M]
    anchors: torch.Tensor,  # [A, 2]
) -> torch.Tensor:
    out = model(images)
    pred_boxes = out["boxes_xyxy"]  # [N, A, 4]
    scores = out["scores"]  # [N, A, nc]
    # jnp.clip: maximum, then minimum
    pred_scores = torch.minimum(torch.maximum(scores, scores.new_full((), _EPS)),
                                scores.new_full((), 1.0 - _EPS))
    n, a, nc = pred_scores.shape
    t_boxes = targets["boxes"]  # [N, M, 4]
    t_cls = targets["classes"].long()  # [N, M]
    t_mask = targets["mask"].to(torch.float32)  # [N, M]
    m = t_boxes.shape[1]

    # nearest-anchor assignment per target (argmin: the first of tied
    # anchors, as jnp.argmin; d2 summed as JAX sums it)
    centers = (t_boxes[..., :2] + t_boxes[..., 2:4]) * 0.5  # [N, M, 2]
    d2 = ((centers[:, :, None, :] - anchors[None, None, :, :]) ** 2).sum(dim=-1)
    assigned = torch.argmin(d2, dim=-1)  # [N, M]

    # scatter one-hot class targets at assigned anchors: JAX's .at[].max,
    # where two targets on one anchor and class meet (duplicate indices)
    batch_idx = torch.arange(n, device=assigned.device)[:, None].expand(n, m)
    flat = ((batch_idx * a + assigned) * nc + t_cls).reshape(-1)
    cls_targets = torch.zeros(n * a * nc, dtype=torch.float32, device=pred_scores.device)
    cls_targets = cls_targets.scatter_reduce(
        0, flat, t_mask.reshape(-1), reduce="amax", include_self=True
    ).reshape(n, a, nc)

    bce = -(
        cls_targets * torch.log(pred_scores)
        + (1.0 - cls_targets) * torch.log(1.0 - pred_scores)
    )
    n_targets = torch.maximum(t_mask.sum(), t_mask.new_ones(()))
    cls_loss = bce.sum() / n_targets

    # IoU loss at assigned anchors, as the diagonal of the [M, M] matrix:
    # the JAX package keeps that form because an elementwise-paired rewrite
    # reorders the backward pass's reductions and moves the trajectory
    pb = torch.gather(pred_boxes, 1, assigned[..., None].expand(n, m, 4))  # [N, M, 4]
    ious = torch.diagonal(iou_matrix(pb, t_boxes), dim1=-2, dim2=-1)  # [N, M]
    box_loss = ((1.0 - ious) * t_mask).sum() / n_targets

    return cls_loss + 5.0 * box_loss


class TrainState(NamedTuple):
    """The model's parameters (by name; the tensors the model holds), the
    optimizer that owns their moments, and the number of steps taken."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: torch.optim.AdamW
    step: int


def make_optimizer(model: YoloModel, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``: decay 1e-4 on every parameter,
    biases included. ``foreach`` on the card; one update per tensor on the
    CPU (one rounding path for the tests)."""
    on_card = next(model.parameters()).device.type == "cuda"
    return torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=BETAS, eps=ADAM_EPS,
        weight_decay=WEIGHT_DECAY, foreach=on_card,
    )


def make_train_step(
    model: YoloModel,
    input_hw: Tuple[int, int],
    learning_rate: float = 1e-3,
    device: Union[str, torch.device] = "cpu",
):
    """Build (init_fn, step_fn) on ``device``; the model moves there and
    its parameters take gradients. The step runs under ``step_numerics``.

    init_fn(seed) -> state: the model's seeded init (``init_params``) and a
    fresh optimizer. step_fn(state, images, targets) -> (state, loss):
    images NHWC float32 RGB in [0, 1], targets numpy or tensors; the loss
    is a zero-dim tensor on the device (no wait for the card).
    """
    if getattr(model, "version", 8) != 8:
        # anchor_centers() lays anchors out in the v8 order (one per cell,
        # scale-major); a v5 head flattens 3 anchors per cell, so nearest-
        # anchor assignment would supervise the WRONG anchors silently
        raise ValueError(
            "make_train_step supports yolov8 models; got version "
            f"{getattr(model, 'version', '?')}"
        )
    device = torch.device(device)
    model.pallas_stem = model.pallas_decode = "off"  # B2 and B3 have no backward
    model.to(device=device, dtype=torch.float32, memory_format=torch.channels_last)
    model.requires_grad_(True)
    anchors = torch.from_numpy(anchor_centers(input_hw)).to(device)

    def init_fn(seed: int = 0) -> TrainState:
        model.init_params(torch.Generator().manual_seed(seed))
        return TrainState(params=dict(model.named_parameters()),
                          opt_state=make_optimizer(model, learning_rate), step=0)

    def step_fn(state: TrainState, images, targets) -> Tuple[TrainState, torch.Tensor]:
        x = torch.as_tensor(images, dtype=torch.float32).to(device)
        tg = {k: torch.as_tensor(v).to(device) for k, v in targets.items()}
        with step_numerics():
            loss = detection_loss(model, x, tg, anchors)
            state.opt_state.zero_grad(set_to_none=True)
            loss.backward()
            state.opt_state.step()
        return TrainState(state.params, state.opt_state, state.step + 1), loss.detach()

    return init_fn, step_fn


@contextlib.contextmanager
def step_numerics() -> Iterator[None]:
    """The train step's numerics for a region: cuDNN without TF32 (the JAX
    step is fp32) and only deterministic kernels (cuDNN's deterministic
    algorithms, no atomics in the backward pass), so a seed and its data
    give one trajectory on every run, as JAX's step does. The settings are
    the process's for the region's duration: another thread that runs torch
    meanwhile runs under them too (and raises on an op without a
    deterministic version). ``torch.empty`` is not filled with NaN, which
    deterministic mode would otherwise do. Everything is restored on exit."""
    cudnn = torch.backends.cudnn
    det = torch.utils.deterministic
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                         allow_tf32=False):
            yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        det.fill_uninitialized_memory = prev[2]


# ---------------------------------------------------------------------------
# optimizer state <-> the params' JAX-layout tree
# ---------------------------------------------------------------------------


def _node(tree, name: str):
    """The tree node that holds parameter ``name`` (``layers.2.m.0.cv1.weight``)
    and its key there (``w`` or ``b``): module names are the tree's keys,
    a ModuleList's the indices of a list."""
    *path, attr = name.split(".")
    node = tree
    for key in path:
        node = node[int(key)] if isinstance(node, list) else node[key]
    return node, {"weight": "w", "bias": "b"}[attr]


def _to_tree_layout(t: torch.Tensor) -> np.ndarray:
    a = t.detach().to(torch.float32).cpu().numpy()
    return np.ascontiguousarray(a.transpose(2, 3, 1, 0) if a.ndim == 4 else a)  # OIHW -> HWIO


def _from_tree_layout(a, like: torch.Tensor, name: str) -> torch.Tensor:
    a = np.asarray(a, np.float32)
    a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a  # HWIO -> OIHW
    if a.shape != tuple(like.shape):
        raise ValueError(f"{name}: {a.shape} does not fit the parameter's {tuple(like.shape)}")
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device).contiguous(
        memory_format=torch.channels_last if like.dim() == 4 else torch.contiguous_format)


def named_tree(model: YoloModel, values: Mapping[str, Optional[torch.Tensor]]) -> Dict:
    """Tensors keyed by the model's parameter names (gradients, moments) as
    a tree in the params' JAX layout; a parameter without one gets zeros."""
    tree = params_to_tree(model)
    for name, _ in model.named_parameters():
        node, leaf = _node(tree, name)
        value = values.get(name)
        node[leaf] = _to_tree_layout(value) if value is not None else np.zeros_like(node[leaf])
    return tree


def opt_state_tree(model: YoloModel, opt: torch.optim.AdamW) -> Dict:
    """The optimizer's state as ``{"count": int, "mu": tree, "nu": tree}``
    (optax's ``ScaleByAdamState`` fields), the trees in the params' JAX
    layout. Before the first step the moments are zeros."""
    states = {name: opt.state.get(p, {}) for name, p in model.named_parameters()}
    count = max((int(st["step"]) for st in states.values() if "step" in st), default=0)
    return {"count": count,
            "mu": named_tree(model, {n: st.get("exp_avg") for n, st in states.items()}),
            "nu": named_tree(model, {n: st.get("exp_avg_sq") for n, st in states.items()})}


def load_opt_state_tree(model: YoloModel, opt: torch.optim.AdamW, state: Dict) -> None:
    """Inverse of ``opt_state_tree``: the moments and the count into
    ``opt``; ValueError if ``state`` is not that layout."""
    if not isinstance(state, dict) or set(state) != {"count", "mu", "nu"}:
        raise ValueError("opt_state must be {'count', 'mu', 'nu'}, got "
                         f"{type(state).__name__}")
    count = int(state["count"])
    for name, p in model.named_parameters():
        moments = []
        for key in ("mu", "nu"):
            try:
                node, leaf = _node(state[key], name)
                value = node[leaf]
            except (KeyError, IndexError, TypeError) as exc:
                raise ValueError(f"opt_state[{key!r}] has no {name}") from exc
            moments.append(_from_tree_layout(value, p, name))
        opt.state[p] = {
            # a CPU step counter, as AdamW keeps it when not capturable
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": moments[0], "exp_avg_sq": moments[1],
        }


def synthetic_targets(
    rng: np.random.Generator, n: int, m: int, input_hw: Tuple[int, int], nc: int
) -> Dict[str, np.ndarray]:
    h, w = input_hw
    xy = rng.uniform(0, 0.7, (n, m, 2)) * (w, h)
    wh = rng.uniform(0.05, 0.3, (n, m, 2)) * (w, h)
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    return {
        "boxes": boxes,
        "classes": rng.integers(0, nc, (n, m)).astype(np.int32),
        "mask": (rng.uniform(size=(n, m)) > 0.3),
    }
