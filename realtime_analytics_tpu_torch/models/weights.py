"""Weights for the PyTorch YOLO, ResNet and temporal modules.

The interchange format is the JAX package's params tree as numpy arrays:
``{"layers": {"0": {"w": HWIO, "b": [O]}, "2": {"cv1": ..., "m": [...]},
...}}`` — the same keys, the same HWIO layout. So

  * ``params_from_jax(model, tree)`` loads a tree (a JAX
    ``init_params``/``apply`` tree turned to numpy, or one this module
    built) into the ``nn.Module``, converting HWIO -> OIHW;
  * ``params_to_tree(model)`` is its inverse;
  * ``yolo_params_from_state_dict`` ports the reference loader
    (``realtime_analytics_tpu/models/weights.py:42-206``): an
    Ultralytics-layout state dict becomes the same tree, every BatchNorm
    folded into its conv (``BN_EPS = 1e-3``, Ultralytics' eps):

        w' = w * gamma / sqrt(var + eps)        (per output channel)
        b' = beta - gamma * mean / sqrt(var + eps)

``quantize_params_int8`` and ``calibrate_int8_activations`` port the JAX
package's native int8 (``realtime_analytics_tpu/models/weights.py:375-450``):
per-output-channel symmetric int8 weights in the tree, then static
activation scales baked by one eager pass of the module.

``load_yolo_checkpoint`` reads ``.pt``/``.pth`` (raw state dict or an
Ultralytics checkpoint dict), a flat ``.npz`` with the same key names, a
native-pytree ``.npz``, or a weights-``.onnx`` (a torch export keeps the
state-dict names in its initializers; ``onnx_lite.read_onnx_initializers``
reads them). Anything unreadable or of another layout -> None (the engine
then serves the file's own ONNX graph, if it has one, or a seeded random
init, loudly).

ResNet and the temporal models follow the same pattern:
``resnet_params_from_jax`` / ``temporal_params_from_jax`` load a JAX tree,
``resnet_params_from_state_dict`` (torchvision names, BN eps 1e-5) and
``temporal_params_from_state_dict`` map torch state dicts
(``temporal_state_dict_from_params`` is the inverse of the last), and
``load_resnet_checkpoint`` / ``load_temporal_checkpoint`` read files.
``load_tree`` and ``module_tree`` walk any of the modules against its tree.

SlowFast R50 (``models/slowfast.py``) reads PySlowFast's ``model_state``
layout (``slowfast_params_from_state_dict``: every BatchNorm3d folded into
its conv in fp32, eps 1e-5); ``slowfast_manifest`` lists that layout's keys
and shapes for a spec and ``slowfast_seeded_state_dict`` fills it from a
seed. MViTv2 (``models/mvit.py``) reads PySlowFast's MViT ``model_state``
key for key (``mvit_params_from_state_dict``: its tree is that flat
layout, in fp32); ``mvit_manifest`` and ``mvit_seeded_state_dict`` are its
layout and seeded weights.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .layers import ConvAct
from .mvit import MViT, MViTSpec
from .resnet import ResNetModel
from .slowfast import SlowFastR50, SlowFastSpec, conv_names
from .yolo import STRIDES, V5_ANCHORS, YoloModel

logger = logging.getLogger(__name__)

BN_EPS = 1e-3  # Ultralytics BatchNorm2d eps
BN_EPS_TORCHVISION = 1e-5


# ---------------------------------------------------------------------------
# params tree <-> module
# ---------------------------------------------------------------------------


def load_tree(module: nn.Module, node, path: str) -> None:
    """Load a params-tree node into ``module`` in place. A leaf module
    (``ConvAct``, ``Dense``, the temporal ``Conv3d`` and ``LSTM``) takes
    its node through ``load_tree``; a ModuleList maps onto a list, any
    other module's children onto the keys of a dict. Every child must be in
    the tree and every shape must match."""
    if hasattr(module, "load_tree"):
        module.load_tree(node, path)
        return
    if isinstance(module, nn.ModuleList):
        if len(node) != len(module):
            raise ValueError(f"{path}: tree has {len(node)} entries, module {len(module)}")
        for j, sub in enumerate(module):
            load_tree(sub, node[j], f"{path}.{j}")
        return
    for name, sub in module.named_children():
        if name not in node:
            raise KeyError(f"{path}.{name} missing from the params tree")
        load_tree(sub, node[name], f"{path}.{name}")


def module_tree(module: nn.Module):
    """Inverse of ``load_tree``: the module's weights as a params tree
    (numpy fp32, JAX layouts)."""
    if hasattr(module, "to_tree"):
        return module.to_tree()
    if isinstance(module, nn.ModuleList):
        return [module_tree(sub) for sub in module]
    return {name: module_tree(sub) for name, sub in module.named_children()}


def params_from_jax(model: YoloModel, tree: Mapping) -> YoloModel:
    """Load a JAX-layout params tree (numpy, HWIO) into ``model`` in place.
    Shapes must match exactly; values keep the module's dtype/device."""
    layers = tree["layers"]
    for name, mod in model.layers.items():
        if name not in layers:
            raise KeyError(f"layers.{name} missing from the params tree")
        load_tree(mod, layers[name], f"layers.{name}")
    model.s2d_prep = None  # scattered from the weights before this load
    return model


def params_to_tree(model: YoloModel) -> Dict:
    """The module's weights as a JAX-layout params tree (numpy fp32, HWIO)."""
    return {"layers": {name: module_tree(mod) for name, mod in model.layers.items()}}


def synthetic_params(model: YoloModel, seed: int = 0) -> Dict:
    """Seeded He-scaled weights with BatchNorm statistics folded in, as a
    params tree for ``model`` — the recipe of
    scripts/gen_golden_fixture.py::synthetic_weights, so activations survive
    every layer and detections depend on the input (a random init with
    class biases at log(0.01/0.99) keeps every score near 0.01). The head's
    plain output convs carry no BatchNorm; v5 anchors keep their defaults."""
    rng = np.random.default_rng(seed)
    tree = params_to_tree(model)

    def conv(node, bn=True):
        kh, kw, ci, co = node["w"].shape
        w = rng.normal(0, np.sqrt(2.0 / (kh * kw * ci)), node["w"].shape)
        b = rng.normal(0, 0.05, co)
        if bn:  # Ultralytics Conv = conv + BatchNorm (eps BN_EPS), folded
            gamma = rng.uniform(0.9, 1.1, co)
            var = rng.uniform(0.8, 1.2, co)
            mean = rng.normal(0, 0.1, co)
            scale = gamma / np.sqrt(var + BN_EPS)
            w, b = w * scale, b - mean * scale
        node["w"], node["b"] = w.astype(np.float32), b.astype(np.float32)

    def fill(node):
        if isinstance(node, dict) and "w" in node:
            conv(node)
        elif isinstance(node, (dict, list)):
            for v in (node.values() if isinstance(node, dict) else node):
                fill(v)

    fill(tree)
    head = tree["layers"][str(model.head_idx)]
    if model.version == 5:
        for level in head["m"]:
            conv(level, bn=False)
        return tree
    for branch in (head["cv2"], head["cv3"]):
        for level in branch:
            conv(level[2], bn=False)
    return tree


# ---------------------------------------------------------------------------
# native int8 (the analog of the reference's RKNN / TensorRT int8 builds)
# ---------------------------------------------------------------------------


def quantize_params_int8(params) -> Dict:
    """Per-output-channel symmetric int8 for every conv weight leaf, in
    numpy exactly as the JAX package's ``quantize_params_int8``: each
    {"w": [..., O], "b"} becomes {"w_q": int8, "w_scale": [O] fp32, "b"};
    ``w_scale = max(max|w| / 127, 1e-12)`` over all axes but the last.
    Non-conv leaves (biases, dense weights, v5 anchors) stay as they are."""

    def q(node):
        w = np.asarray(node["w"], dtype=np.float32)
        if w.ndim < 4:  # only conv kernels (HWIO); keep dense weights fp
            return node
        scale = np.max(np.abs(w), axis=tuple(range(w.ndim - 1))) / 127.0
        scale = np.maximum(scale, 1e-12)
        wq = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
        out = {k: v for k, v in node.items() if k != "w"}
        out["w_q"] = wq
        out["w_scale"] = scale.astype(np.float32)
        return out

    def walk(node):
        if isinstance(node, dict):
            if "w" in node:
                return q(node)
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(params)


def calibrate_int8_activations(model: YoloModel, sample_inputs,
                               device: torch.device) -> int:
    """Bake static per-tensor activation scales into a quantised module.

    Runs the module eagerly over ``sample_inputs`` (model-ready fp32
    arrays [N, H, W, 3], RGB in [0, 1]) on ``device``, a forward pre-hook
    on every ``ConvAct`` recording the max |input| it saw (the JAX
    package's ``_calibration_sink``), then sets ``a_scale = max(seen,
    1e-8) / 127`` (fp32) on each int8 ``ConvAct`` that was called, as the
    JAX package's ``calibrate_int8_activations``. The module's convs are
    int8 already, so later convs see dynamically quantised inputs. The v5
    head convs are not ``conv_act`` calls in the JAX package and are not
    called as modules here either. Returns the number of scales baked."""
    seen: Dict[ConvAct, list] = {}

    def record(mod, args):
        seen.setdefault(mod, []).append(float(args[0].to(torch.float32).abs().amax()))

    hooks = [m.register_forward_pre_hook(record)
             for m in model.modules() if isinstance(m, ConvAct)]
    try:
        with torch.inference_mode():
            for x in sample_inputs:
                model(torch.as_tensor(np.asarray(x, np.float32)).to(device))
    finally:
        for h in hooks:
            h.remove()
    baked = 0
    for m, maxes in seen.items():
        if m.w_q is not None:
            m.a_scale = torch.tensor(max(max(maxes), 1e-8) / 127.0,
                                     dtype=torch.float32, device=m.w_q.device)
            baked += 1
    logger.info("int8 calibration: baked %d activation scales", baked)
    return baked


def _tree_shapes(node):
    if isinstance(node, dict):
        return {k: _tree_shapes(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_tree_shapes(v) for v in node]
    return tuple(np.shape(node))


# ---------------------------------------------------------------------------
# Ultralytics state dicts
# ---------------------------------------------------------------------------


def _np(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    return t.detach().cpu().numpy()  # torch tensor


def _fold_conv_bn(
    sd: Mapping[str, np.ndarray], conv_prefix: str, bn_prefix: Optional[str],
    eps: float = BN_EPS,
) -> Dict[str, np.ndarray]:
    """OIHW conv (+BN) -> fused {"w": HWIO, "b": [O]} (numpy fp32)."""
    w = _np(sd[f"{conv_prefix}.weight"]).astype(np.float32)  # [O, I, kh, kw]
    b = (
        _np(sd[f"{conv_prefix}.bias"]).astype(np.float32)
        if f"{conv_prefix}.bias" in sd
        else np.zeros(w.shape[0], np.float32)
    )
    if bn_prefix is not None and f"{bn_prefix}.weight" in sd:
        gamma = _np(sd[f"{bn_prefix}.weight"]).astype(np.float32)
        beta = _np(sd[f"{bn_prefix}.bias"]).astype(np.float32)
        mean = _np(sd[f"{bn_prefix}.running_mean"]).astype(np.float32)
        var = _np(sd[f"{bn_prefix}.running_var"]).astype(np.float32)
        scale = gamma / np.sqrt(var + eps)
        w = w * scale[:, None, None, None]
        b = beta + (b - mean) * scale
    return {"w": w.transpose(2, 3, 1, 0), "b": b}  # OIHW -> HWIO


def _conv_block(sd, prefix: str) -> Dict:
    """Ultralytics "Conv" module: <prefix>.conv + <prefix>.bn."""
    return _fold_conv_bn(sd, f"{prefix}.conv", f"{prefix}.bn")


def _bottleneck(sd, prefix: str) -> Dict:
    return {"cv1": _conv_block(sd, f"{prefix}.cv1"),
            "cv2": _conv_block(sd, f"{prefix}.cv2")}


def yolo_params_from_state_dict(
    model: YoloModel, sd: Mapping[str, np.ndarray], prefix: str = "model."
) -> Dict:
    """Map an Ultralytics-layout v5 or v8 state dict onto the params tree."""
    layers: Dict[str, Dict] = {}
    for i, node in enumerate(model.nodes):
        base = f"{prefix}{i}"
        if node.kind == "conv":
            layers[str(i)] = _conv_block(sd, base)
        elif node.kind in ("c2f", "c3"):
            p = {
                "cv1": _conv_block(sd, f"{base}.cv1"),
                "cv2": _conv_block(sd, f"{base}.cv2"),
                "m": [_bottleneck(sd, f"{base}.m.{j}") for j in range(node.n)],
            }
            if node.kind == "c3":
                p["cv3"] = _conv_block(sd, f"{base}.cv3")
            layers[str(i)] = p
        elif node.kind == "sppf":
            layers[str(i)] = {
                "cv1": _conv_block(sd, f"{base}.cv1"),
                "cv2": _conv_block(sd, f"{base}.cv2"),
            }
        elif node.kind == "detect_v8":
            cv2, cv3 = [], []
            for lvl in range(3):
                cv2.append([
                    _conv_block(sd, f"{base}.cv2.{lvl}.0"),
                    _conv_block(sd, f"{base}.cv2.{lvl}.1"),
                    _fold_conv_bn(sd, f"{base}.cv2.{lvl}.2", None),
                ])
                cv3.append([
                    _conv_block(sd, f"{base}.cv3.{lvl}.0"),
                    _conv_block(sd, f"{base}.cv3.{lvl}.1"),
                    _fold_conv_bn(sd, f"{base}.cv3.{lvl}.2", None),
                ])
            layers[str(i)] = {"cv2": cv2, "cv3": cv3}
        elif node.kind == "detect_v5":
            p = {"m": [_fold_conv_bn(sd, f"{base}.m.{lvl}", None) for lvl in range(3)]}
            # the published .pt registers `anchors` divided by stride
            # (yolov5 Detect.__init__); multiply back to input pixels
            if f"{base}.anchors" in sd:
                a = _np(sd[f"{base}.anchors"]).astype(np.float32)  # [3, na, 2]
                p["anchors"] = a * np.asarray(STRIDES, np.float32)[:, None, None]
            else:
                p["anchors"] = np.asarray(V5_ANCHORS, np.float32)
            layers[str(i)] = p
    return {"layers": layers}


def load_yolo_checkpoint(model: YoloModel, path: str) -> Optional[Dict]:
    """Best-effort load of a YOLO checkpoint file into a params tree.
    Returns None when the file is missing, unreadable or of another layout."""
    try:
        sd = _read_state_dict(path)
    except Exception as exc:  # noqa: BLE001 — any unreadable file -> None
        logger.warning("Could not read checkpoint %s: %s", path, exc)
        return None
    if sd is None:
        return None
    if "__pytree__" in sd:
        return _check_tree(model, sd["__pytree__"].item(), path)
    # Ultralytics full-model state dicts prefix everything with "model.".
    prefix = "model." if any(k.startswith("model.0.") for k in sd) else ""
    try:
        return yolo_params_from_state_dict(model, sd, prefix=prefix)
    except KeyError as exc:
        logger.warning(
            "Checkpoint %s does not match yolov%d%s layout (missing %s)",
            path, model.version, model.size, exc,
        )
        return None


def _read_state_dict(path: str) -> Optional[Mapping[str, np.ndarray]]:
    if path.endswith(".npz"):
        flat = dict(np.load(path, allow_pickle=True))
        if "__pytree__" in flat:
            # native params tree (e.g. saved by the JAX package's trainer)
            return {"__pytree__": flat["__pytree__"]}
        return flat
    if path.endswith(".onnx"):
        from .onnx_lite import read_onnx_initializers

        return {k: v.astype(np.float32) if v.dtype == np.float16 else v
                for k, v in read_onnx_initializers(path).items()}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model", "model_state"):
            if key in obj:
                inner = obj[key]
                if hasattr(inner, "state_dict"):
                    inner = inner.float().state_dict()
                if isinstance(inner, dict):
                    return {k: _np(v) for k, v in inner.items()}
        if all(hasattr(v, "detach") or isinstance(v, np.ndarray) for v in obj.values()):
            return {k: _np(v) for k, v in obj.items()}
    if hasattr(obj, "state_dict"):
        return {k: _np(v) for k, v in obj.float().state_dict().items()}
    return None


def _check_tree(model: nn.Module, tree, path: str) -> Optional[Dict]:
    """``tree`` when its shapes match the module's, else None (warned)."""
    if _tree_shapes(tree) != _tree_shapes(module_tree(model)):
        logger.warning("pytree checkpoint %s does not match the model", path)
        return None
    return tree


def _seeded_tree(model: nn.Module, seed: int) -> Dict:
    """Seeded weights for ``model`` as a params tree, from a
    ``torch.Generator``: He-normal convs (HWIO / DHWIO, fan-in over every
    axis but the last) with small biases, dense layers at 1/sqrt(in) with
    zero biases, LSTM weights N(0, 0.05) as the JAX init draws them."""
    gen = torch.Generator().manual_seed(seed)

    def randn(shape):
        return torch.randn(tuple(shape), generator=gen, dtype=torch.float64).numpy()

    def fill(node):
        if isinstance(node, list):
            return [fill(v) for v in node]
        if "wx" in node:  # LSTM
            return {"wx": (randn(node["wx"].shape) * 0.05).astype(np.float32),
                    "wh": (randn(node["wh"].shape) * 0.05).astype(np.float32),
                    "b": np.zeros_like(node["b"])}
        if "w" not in node:
            return {k: fill(v) for k, v in node.items()}
        shape = node["w"].shape
        fan_in = int(np.prod(shape[:-1]))
        if len(shape) == 2:
            w, b = randn(shape) / np.sqrt(fan_in), np.zeros(shape[-1])
        else:
            w, b = randn(shape) * np.sqrt(2.0 / fan_in), randn((shape[-1],)) * 0.05
        return {"w": w.astype(np.float32), "b": b.astype(np.float32)}

    return fill(module_tree(model))


# ---------------------------------------------------------------------------
# ResNet (torchvision layout)
# ---------------------------------------------------------------------------


def resnet_params_from_jax(model: ResNetModel, tree: Mapping) -> ResNetModel:
    """Load a JAX ResNet params tree (numpy, HWIO; ``fc.w`` [in, out]) into
    ``model`` in place."""
    load_tree(model, tree, "resnet")
    return model


def resnet_synthetic_params(model: ResNetModel, seed: int = 0) -> Dict:
    """Seeded He-scaled ResNet weights (``_seeded_tree``), with the last
    conv of every residual branch scaled by 0.5 so the activations stay
    bounded through the 16 blocks of ResNet-50."""
    tree = _seeded_tree(model, seed)
    last = "conv3" if model.bottleneck else "conv2"
    for blocks in tree["layers"]:
        for blk in blocks:
            blk[last]["w"] *= np.float32(0.5)
    return tree


def resnet_params_from_state_dict(model: ResNetModel, sd: Mapping[str, np.ndarray]) -> Dict:
    """Map a torchvision-named ResNet state dict onto the params tree,
    every BatchNorm folded (``BN_EPS_TORCHVISION``)."""
    eps = BN_EPS_TORCHVISION
    params: Dict = {"stem": _fold_conv_bn(sd, "conv1", "bn1", eps=eps)}
    layers: List[List[Dict]] = []
    for stage_idx, n_blocks in enumerate(model.stages):
        blocks = []
        for b in range(n_blocks):
            base = f"layer{stage_idx + 1}.{b}"
            blk = {
                "conv1": _fold_conv_bn(sd, f"{base}.conv1", f"{base}.bn1", eps=eps),
                "conv2": _fold_conv_bn(sd, f"{base}.conv2", f"{base}.bn2", eps=eps),
            }
            if model.bottleneck:
                blk["conv3"] = _fold_conv_bn(sd, f"{base}.conv3", f"{base}.bn3", eps=eps)
            if f"{base}.downsample.0.weight" in sd:
                blk["down"] = _fold_conv_bn(
                    sd, f"{base}.downsample.0", f"{base}.downsample.1", eps=eps
                )
            blocks.append(blk)
        layers.append(blocks)
    params["layers"] = layers
    params["fc"] = _t_dense(sd, "fc")
    return params


def load_resnet_checkpoint(model: ResNetModel, path: str) -> Optional[Dict]:
    """A torchvision-named state dict (.pt / flat .npz / weights-.onnx) or a
    native params-tree .npz. Anything unreadable or of another layout ->
    None."""
    try:
        sd = _read_state_dict(path)
        if sd is None:
            return None
        if "__pytree__" in sd:
            return _check_tree(model, sd["__pytree__"].item(), path)
        return resnet_params_from_state_dict(model, sd)
    except Exception as exc:  # noqa: BLE001 — any unreadable file -> None
        logger.warning("Could not load ResNet checkpoint %s: %s", path, exc)
        return None


# ---------------------------------------------------------------------------
# Temporal models: torch-named state dicts (the JAX package's contract:
# scripts/export_temporal_model.py names) -> params trees
# ---------------------------------------------------------------------------


def _t_bias(sd, name: str, cout: int) -> np.ndarray:
    key = f"{name}.bias"
    return _np(sd[key]).astype(np.float32) if key in sd else np.zeros(cout, np.float32)


def _t_conv(sd, name: str) -> Dict[str, np.ndarray]:
    """torch Conv2d (OIHW) -> {"w": HWIO, "b"}."""
    w = _np(sd[f"{name}.weight"]).astype(np.float32)
    return {"w": w.transpose(2, 3, 1, 0), "b": _t_bias(sd, name, w.shape[0])}


def _t_conv3d(sd, name: str) -> Dict[str, np.ndarray]:
    """torch Conv3d (OIDHW) -> {"w": DHWIO, "b"}."""
    w = _np(sd[f"{name}.weight"]).astype(np.float32)
    return {"w": w.transpose(2, 3, 4, 1, 0), "b": _t_bias(sd, name, w.shape[0])}


def _t_dense(sd, name: str) -> Dict[str, np.ndarray]:
    """torch Linear ([out, in]) -> {"w": [in, out], "b"}."""
    return {"w": _np(sd[f"{name}.weight"]).astype(np.float32).T,
            "b": _np(sd[f"{name}.bias"]).astype(np.float32)}


def temporal_params_from_state_dict(model: nn.Module, sd: Mapping[str, np.ndarray]) -> Dict:
    """Map a torch-named temporal state dict onto the model's params tree.
    torch ``nn.LSTM`` packs its gates i, f, g, o along dim 0 — the order
    the cell splits — so the LSTM maps by a transpose and the sum of its
    two bias vectors."""
    kind = type(model).__name__
    if kind == "CNNLSTM":
        return {
            "encoder": {"c1": _t_conv(sd, "c1"), "c2": _t_conv(sd, "c2"),
                        "c3": _t_conv(sd, "c3"), "proj": _t_dense(sd, "proj")},
            "lstm": {
                "wx": _np(sd["lstm.weight_ih_l0"]).astype(np.float32).T,
                "wh": _np(sd["lstm.weight_hh_l0"]).astype(np.float32).T,
                "b": (_np(sd["lstm.bias_ih_l0"]).astype(np.float32)
                      + _np(sd["lstm.bias_hh_l0"]).astype(np.float32)),
            },
            "fc": _t_dense(sd, "fc"),
        }
    if kind == "ConvGRU":
        tree = {n: _t_conv(sd, n) for n in ("stem", "zr", "hcand", "head")}
        tree["fc"] = _t_dense(sd, "fc")
        return tree
    if kind == "CNN3D":
        tree = {n: _t_conv3d(sd, n) for n in ("c1", "c2", "c3", "c4")}
        tree["fc"] = _t_dense(sd, "fc")
        return tree
    if kind == "SlowFastR50":
        return slowfast_params_from_state_dict(model, sd)
    if kind == "MViT":
        return mvit_params_from_state_dict(model, sd)
    if kind == "SlowFast":
        return {
            "slow": {f"c{j}": _t_conv3d(sd, f"slow.c{j}") for j in (1, 2, 3)},
            "fast": {f"c{j}": _t_conv3d(sd, f"fast.c{j}") for j in (1, 2, 3)},
            "fc": _t_dense(sd, "fc"),
        }
    raise ValueError(f"unsupported temporal model class: {kind}")


def temporal_state_dict_from_params(model: nn.Module, params: Mapping) -> Dict[str, np.ndarray]:
    """Inverse of ``temporal_params_from_state_dict`` (the JAX package's
    function of the same name): params tree -> torch-named arrays (OIHW,
    OIDHW, [out, in]), for .onnx / .npz export. The LSTM's summed bias goes
    to ``bias_ih_l0`` and ``bias_hh_l0`` is zero."""

    def conv(p):
        return {"weight": np.asarray(p["w"]).transpose(3, 2, 0, 1), "bias": np.asarray(p["b"])}

    def conv3d(p):
        return {"weight": np.asarray(p["w"]).transpose(4, 3, 0, 1, 2),
                "bias": np.asarray(p["b"])}

    def dense(p):
        return {"weight": np.asarray(p["w"]).T, "bias": np.asarray(p["b"])}

    def flat(prefix, d):
        return {f"{prefix}.{k}": v for k, v in d.items()}

    kind = type(model).__name__
    out: Dict[str, np.ndarray] = {}
    if kind == "CNNLSTM":
        enc = params["encoder"]
        for n in ("c1", "c2", "c3"):
            out.update(flat(n, conv(enc[n])))
        out.update(flat("proj", dense(enc["proj"])))
        lstm = params["lstm"]
        out["lstm.weight_ih_l0"] = np.asarray(lstm["wx"]).T
        out["lstm.weight_hh_l0"] = np.asarray(lstm["wh"]).T
        out["lstm.bias_ih_l0"] = np.asarray(lstm["b"])
        out["lstm.bias_hh_l0"] = np.zeros_like(np.asarray(lstm["b"]))
        out.update(flat("fc", dense(params["fc"])))
    elif kind == "ConvGRU":
        for n in ("stem", "zr", "hcand", "head"):
            out.update(flat(n, conv(params[n])))
        out.update(flat("fc", dense(params["fc"])))
    elif kind == "CNN3D":
        for n in ("c1", "c2", "c3", "c4"):
            out.update(flat(n, conv3d(params[n])))
        out.update(flat("fc", dense(params["fc"])))
    elif kind == "SlowFast":
        for path in ("slow", "fast"):
            for j in (1, 2, 3):
                out.update(flat(f"{path}.c{j}", conv3d(params[path][f"c{j}"])))
        out.update(flat("fc", dense(params["fc"])))
    else:
        raise ValueError(f"unsupported temporal model class: {kind}")
    return out


def temporal_params_from_jax(model: nn.Module, tree: Mapping) -> nn.Module:
    """Load a JAX temporal params tree (numpy; HWIO, DHWIO, dense [in, out],
    LSTM wx/wh/b) into ``model`` in place."""
    load_tree(model, tree, type(model).__name__)
    return model


def temporal_synthetic_params(model: nn.Module, seed: int = 0) -> Dict:
    """Seeded He-scaled temporal weights (``_seeded_tree``); SlowFast R50's
    are ``slowfast_seeded_state_dict``'s, folded, MViT's
    ``mvit_seeded_state_dict``'s."""
    if isinstance(model, SlowFastR50):
        return slowfast_params_from_state_dict(model, slowfast_seeded_state_dict(model.spec, seed))
    if isinstance(model, MViT):
        return mvit_params_from_state_dict(model, mvit_seeded_state_dict(model.spec, seed))
    return _seeded_tree(model, seed)


def load_temporal_checkpoint(model: nn.Module, path: str) -> Optional[Dict]:
    """A native params-tree .npz, or a torch-named state dict (flat .npz,
    .pt or weights-.onnx). Anything unreadable or of another layout ->
    None."""
    try:
        sd = _read_state_dict(path)
        if sd is None:
            return None
        if "__pytree__" in sd:
            return _check_tree(model, sd["__pytree__"].item(), path)
        return temporal_params_from_state_dict(model, sd)
    except Exception as exc:  # noqa: BLE001 — any unreadable file -> None
        logger.warning("Could not load temporal checkpoint %s: %s", path, exc)
        return None


# ---------------------------------------------------------------------------
# SlowFast R50: PySlowFast's model_state layout
# ---------------------------------------------------------------------------

BN_EPS_SLOWFAST = 1e-5  # PySlowFast's nn.BatchNorm3d (BN.EPSILON)
# the seeded weights' scales (``slowfast_seeded_state_dict``)
SEED_GAMMA = (0.8, 1.2)  # every BN but a bottleneck's last
SEED_LAST_GAMMA = (0.2, 0.4)  # branch2.c_bn: the residual branch, live and bounded


def slowfast_bn_name(conv: str) -> str:
    """The BatchNorm3d that follows a conv in PySlowFast's layout:
    ``x.conv`` -> ``x.bn`` (stems), ``x.conv_f2s`` -> ``x.bn`` (laterals),
    ``...branch1`` -> ``...branch1_bn``, ``...branch2.a`` ->
    ``...branch2.a_bn``."""
    head, _, last = conv.rpartition(".")
    return f"{head}.bn" if last in ("conv", "conv_f2s") else f"{conv}_bn"


def slowfast_manifest(spec: SlowFastSpec = SlowFastSpec()) -> Dict[str, tuple]:
    """Every key and shape of PySlowFast's ``model_state`` for ``spec``, in
    its order."""
    with torch.device("meta"):
        model = SlowFastR50(spec)
    mods = dict(model.named_modules())
    out: Dict[str, tuple] = {}
    for name in conv_names(model):
        w = mods[name].weight
        out[f"{name}.weight"] = tuple(w.shape)
        bn = slowfast_bn_name(name)
        for k in ("weight", "bias", "running_mean", "running_var"):
            out[f"{bn}.{k}"] = (w.shape[0],)
        out[f"{bn}.num_batches_tracked"] = ()
    out["head.projection.weight"] = (spec.num_classes, spec.features)
    out["head.projection.bias"] = (spec.num_classes,)
    return out


def slowfast_seeded_state_dict(spec: SlowFastSpec = SlowFastSpec(), seed: int = 0,
                               device="cpu") -> Dict[str, torch.Tensor]:
    """A PySlowFast ``model_state`` for ``spec`` from ``seed``, fp32 on
    ``device``, drawn from one ``torch.Generator`` (a normal and a uniform
    over every element, split key by key):

    * a conv's weight He-normal (std ``sqrt(2 / fan_in)``), so a conv and
      ReLU keep their input's scale;
    * a BN's running mean ``0.1 N``, running variance in [0.75, 1.25], beta
      ``0.1 N``, gamma in ``SEED_GAMMA``, but a bottleneck's last
      (``branch2.c_bn``, which PySlowFast's ``ZERO_INIT_FINAL_BN`` would zero)
      in ``SEED_LAST_GAMMA``: each residual branch adds a third of its
      shortcut's scale, so every branch and lateral counts and the scale
      grows by a few times over the 16 blocks;
    * the projection ``N / sqrt(features)``, its bias
      ``0.1 N``: logits of a few units, no class taking the softmax whole.

    The same seed gives the same state on one kind of device."""
    manifest = slowfast_manifest(spec)
    sizes = [int(np.prod(s)) for s in manifest.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for (key, shape), size in zip(manifest.items(), sizes):
        n, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        if key.endswith("num_batches_tracked"):
            sd[key] = torch.zeros((), dtype=torch.long, device=device)
        elif key == "head.projection.weight":
            sd[key] = n * (1.0 / np.sqrt(shape[1]))
        elif key.endswith(".running_mean") or key.endswith(".bias"):
            sd[key] = 0.1 * n
        elif key.endswith(".running_var"):
            sd[key] = 0.75 + 0.5 * u
        elif key.endswith("_bn.weight") or key.endswith(".bn.weight"):
            lo, hi = SEED_LAST_GAMMA if key.endswith(".c_bn.weight") else SEED_GAMMA
            sd[key] = lo + (hi - lo) * u
        else:  # a conv's weight
            sd[key] = n * np.sqrt(2.0 / np.prod(shape[1:]))
    return sd


def _fold_conv3d_bn(sd, conv: str, eps: float = BN_EPS_SLOWFAST) -> Dict[str, np.ndarray]:
    """A bias-free OIDHW conv and its BatchNorm3d -> {"w": DHWIO, "b"}, in fp32."""
    w = _np(sd[f"{conv}.weight"]).astype(np.float32)
    bn = slowfast_bn_name(conv)
    gamma, beta, mean, var = (_np(sd[f"{bn}.{k}"]).astype(np.float32)
                              for k in ("weight", "bias", "running_mean", "running_var"))
    scale = gamma / np.sqrt(var + np.float32(eps))
    return {"w": (w * scale[:, None, None, None, None]).transpose(2, 3, 4, 1, 0),
            "b": beta - mean * scale}


def slowfast_params_from_state_dict(model: SlowFastR50, sd: Mapping) -> Dict:
    """PySlowFast's ``model_state`` (numpy or torch) -> ``model``'s params
    tree, each conv's BN folded; a missing key raises ``KeyError``."""
    tree: Dict = {}
    for name in conv_names(model):
        *path, last = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[last] = _fold_conv3d_bn(sd, name)
    tree["head"] = {"projection": _t_dense(sd, "head.projection")}
    return tree


# ---------------------------------------------------------------------------
# MViTv2: PySlowFast's MViT model_state layout
# ---------------------------------------------------------------------------

SEED_LN_GAMMA = (0.8, 1.2)  # the seeded LayerNorms' weights (``mvit_seeded_state_dict``)


def mvit_manifest(spec: MViTSpec = MViTSpec()) -> Dict[str, tuple]:
    """Every key and shape of PySlowFast's MViT ``model_state`` for ``spec``,
    in its order."""
    with torch.device("meta"):
        model = MViT(spec)
    return {k: tuple(v.shape) for k, v in model.state_dict().items()}


def mvit_seeded_state_dict(spec: MViTSpec = MViTSpec(), seed: int = 0,
                           device="cpu") -> Dict[str, torch.Tensor]:
    """A PySlowFast MViT ``model_state`` for ``spec`` from ``seed``, fp32 on
    ``device``, drawn from one ``torch.Generator`` (a normal and a uniform
    over every element, split key by key): a LayerNorm's weight in
    ``SEED_LN_GAMMA``, every bias ``0.1 N``, every other tensor (linears,
    convs, the pools, the relative-position tables, the cls token)
    ``N / sqrt(fan_in)`` over all its axes but the first, so each branch
    adds about its input's scale and the relative-position bias is of the
    logits' order. The same seed gives the same state on one kind of
    device."""
    manifest = mvit_manifest(spec)
    sizes = [int(np.prod(s)) for s in manifest.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    sd: Dict[str, torch.Tensor] = {}
    at = 0
    for (key, shape), size in zip(manifest.items(), sizes):
        n, u = normal[at:at + size].view(shape), uniform[at:at + size].view(shape)
        at += size
        if key.endswith(".bias"):
            sd[key] = 0.1 * n
        elif len(shape) == 1:  # a LayerNorm's weight
            lo, hi = SEED_LN_GAMMA
            sd[key] = lo + (hi - lo) * u
        else:
            sd[key] = n * (1.0 / np.sqrt(np.prod(shape[1:])))
    return sd


def mvit_params_from_state_dict(model: MViT, sd: Mapping) -> Dict[str, np.ndarray]:
    """PySlowFast's MViT ``model_state`` (numpy or torch) -> ``model``'s
    params tree (the same flat keys, fp32); a missing key raises
    ``KeyError``."""
    return {name: _np(sd[name]).astype(np.float32) for name, _ in model.named_parameters()}
