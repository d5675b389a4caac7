"""Detection training step, on one device or over a (dp, tp) or (dp, sp, tp) mesh.

Counterpart of ``realtime_analytics_tpu/parallel/train.py``: forward, the
same anchor-free detection loss, backward and an AdamW update (optax's
``adamw`` defaults), on one card (or the CPU), or over an in-process
(dp, tp) mesh (``parallel/mesh.py``): the batch splits over dp, conv
output channels over tp, and the parameters and their AdamW moments are
sharded by the same rule (``_leaf_spec``). On a (dp, sp, tp) mesh the
images also split by height over sp, as JAX's ``P("dp", "sp", None,
None)`` (``parallel/spatial.py``); gradients reach row 0's tensors through
the halo copies by autograd. The loss is the global batch's,
as one device computes it: every row's outputs are joined on the mesh's
first device before the loss, and each row's gradients reach the sharded
parameters through autograd (the all-reduce). After each step the model's
own tensors take the joined parameters, so that it can be saved or served.

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
The step runs the layer-by-layer neck (``fuse_neck`` off), where JAX's
``detection_loss`` applies its default, fused forward. The two are one
function up to rounding, and their gradients agree (the fused step, with
autograd through views of the split weights, is held against JAX's in
tests/test_torch_neck_fusion.py), but the train CLI's 400-step recipe is
chaotic in its rounding: from the same init it ends at loss 3.42
unfused and 19.97 fused on the CPU (4 threads), and fused on the card its
map50 is 0, no better than a random init's.
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
from .mesh import Mesh, ShardedModel

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
    model,
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
    """The parameters the optimizer updates, by name (the model's own, or
    under a mesh the sharded ones), the optimizer that owns their moments,
    the number of steps taken, and under a mesh the model over it."""

    params: Dict[str, torch.nn.Parameter]
    opt_state: torch.optim.AdamW
    step: int
    net: Optional[ShardedModel] = None


def make_optimizer(model, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``: decay 1e-4 on every parameter,
    biases included. ``foreach`` on the card; one update per tensor on the
    CPU (one rounding path for the tests). ``model``: a module, or a
    ``ShardedModel`` (its sharded parameters)."""
    on_card = next(model.parameters()).device.type == "cuda"
    return torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=BETAS, eps=ADAM_EPS,
        weight_decay=WEIGHT_DECAY, foreach=on_card,
    )


def make_train_step(
    model: YoloModel,
    input_hw: Tuple[int, int],
    learning_rate: float = 1e-3,
    device: Union[str, torch.device, None] = None,
    mesh: Optional[Mesh] = None,
):
    """Build (init_fn, step_fn) on ``device`` (None: the card, raising
    when none is visible; "cpu" is the CPU) or over ``mesh`` (on its
    devices; the model moves to its first); the model's parameters take
    gradients. The step runs under ``step_numerics``.

    init_fn(seed) -> state: the model's seeded init (``init_params``) and a
    fresh optimizer (over the sharded parameters under a mesh).
    step_fn(state, images, targets) -> (state, loss): images NHWC float32
    RGB in [0, 1], targets numpy or tensors; the loss is a zero-dim tensor
    on the device (no wait for the card).
    """
    if getattr(model, "version", 8) != 8:
        # anchor_centers() lays anchors out in the v8 order (one per cell,
        # scale-major); a v5 head flattens 3 anchors per cell, so nearest-
        # anchor assignment would supervise the WRONG anchors silently
        raise ValueError(
            "make_train_step supports yolov8 models; got version "
            f"{getattr(model, 'version', '?')}"
        )
    if mesh is not None:
        lead = mesh.lead(0)
        if device is not None and torch.device(device) != lead:
            raise ValueError(f"device {device} is not the mesh's first device {lead}")
        device = lead
    elif device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_train_step: device=None means the card and none is "
                               "visible; pass device='cpu' to train on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    model.pallas_stem = model.pallas_decode = "off"  # B2 and B3 have no backward
    model.fuse_neck = False  # the layer-by-layer neck (see the module docstring)
    model.to(device=device, dtype=torch.float32, memory_format=torch.channels_last)
    model.requires_grad_(True)
    anchors = torch.from_numpy(anchor_centers(input_hw)).to(device)

    def init_fn(seed: int = 0) -> TrainState:
        model.init_params(torch.Generator().manual_seed(seed))
        net = None if mesh is None else ShardedModel(model, mesh)
        return TrainState(params=dict((net or model).named_parameters()),
                          opt_state=make_optimizer(net or model, learning_rate), step=0,
                          net=net)

    def step_fn(state: TrainState, images, targets) -> Tuple[TrainState, torch.Tensor]:
        x = torch.as_tensor(images, dtype=torch.float32).to(device)
        tg = {k: torch.as_tensor(v).to(device) for k, v in targets.items()}
        with step_numerics():
            loss = detection_loss(state.net or model, x, tg, anchors)
            state.opt_state.zero_grad(set_to_none=True)
            loss.backward()
            state.opt_state.step()
            if state.net is not None:
                state.net.gather_into_module()
        return state._replace(step=state.step + 1), loss.detach()

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


def opt_state_tree(model: YoloModel, opt: torch.optim.AdamW,
                   net: Optional[ShardedModel] = None) -> Dict:
    """The optimizer's state as ``{"count": int, "mu": tree, "nu": tree}``
    (optax's ``ScaleByAdamState`` fields), the trees in the params' JAX
    layout. Before the first step the moments are zeros. ``net``: the
    model over a mesh whose sharded parameters ``opt`` updates (their
    moments are joined)."""
    states = {name: opt.state.get(p, {}) for name, p in (net or model).named_parameters()}
    count = max((int(st["step"]) for st in states.values() if "step" in st), default=0)
    moments = {}
    for key, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        values = {n: st.get(field) for n, st in states.items()}
        moments[key] = named_tree(model, net.joined(values) if net is not None else values)
    return {"count": count, **moments}


def load_opt_state_tree(model: YoloModel, opt: torch.optim.AdamW, state: Dict,
                        net: Optional[ShardedModel] = None) -> None:
    """Inverse of ``opt_state_tree``: the moments and the count into
    ``opt`` (into the sharded parameters' slots under a mesh: ``net``);
    ValueError if ``state`` is not that layout."""
    if not isinstance(state, dict) or set(state) != {"count", "mu", "nu"}:
        raise ValueError("opt_state must be {'count', 'mu', 'nu'}, got "
                         f"{type(state).__name__}")
    count = int(state["count"])
    moments = {"mu": {}, "nu": {}}
    for name, p in model.named_parameters():
        for key in ("mu", "nu"):
            try:
                node, leaf = _node(state[key], name)
                value = node[leaf]
            except (KeyError, IndexError, TypeError) as exc:
                raise ValueError(f"opt_state[{key!r}] has no {name}") from exc
            moments[key][name] = _from_tree_layout(value, p, name)
    if net is not None:
        moments = {key: net.split(values) for key, values in moments.items()}
    for name, p in (net or model).named_parameters():
        mu, nu = (moments[key][name].to(p.device).contiguous(
            memory_format=torch.channels_last if p.dim() == 4 else torch.contiguous_format)
            for key in ("mu", "nu"))
        opt.state[p] = {
            # a CPU step counter, as AdamW keeps it when not capturable
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu, "exp_avg_sq": nu,
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
