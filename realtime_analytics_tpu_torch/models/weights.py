"""Weights for the PyTorch YOLO module.

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

``load_yolo_checkpoint`` reads ``.pt``/``.pth`` (raw state dict or an
Ultralytics checkpoint dict), a flat ``.npz`` with the same key names, or
a native-pytree ``.npz``; a weights-``.onnx`` raises NotImplementedError
until the ONNX reader is ported (ROADMAP.md). Anything unreadable -> None
(the engine then uses a seeded random init, loudly).
"""

from __future__ import annotations

import logging
from typing import Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .yolo import ConvAct, YoloModel

logger = logging.getLogger(__name__)

BN_EPS = 1e-3  # Ultralytics BatchNorm2d eps


# ---------------------------------------------------------------------------
# params tree <-> module
# ---------------------------------------------------------------------------


def _walk(module: nn.Module, node, fn, path: str) -> None:
    """Visit every ConvAct of ``module`` with its params-tree node."""
    if isinstance(module, ConvAct):
        fn(module, node, path)
        return
    if isinstance(module, nn.ModuleList):
        if len(node) != len(module):
            raise ValueError(f"{path}: tree has {len(node)} entries, module {len(module)}")
        for j, sub in enumerate(module):
            _walk(sub, node[j], fn, f"{path}.{j}")
        return
    for name, sub in module.named_children():
        if name not in node:
            raise KeyError(f"{path}.{name} missing from the params tree")
        _walk(sub, node[name], fn, f"{path}.{name}")


@torch.no_grad()
def params_from_jax(model: YoloModel, tree: Mapping) -> YoloModel:
    """Load a JAX-layout params tree (numpy, HWIO) into ``model`` in place.
    Shapes must match exactly; values keep the module's dtype/device."""

    def load(mod: ConvAct, node, path):
        w = np.array(node["w"], dtype=np.float32).transpose(3, 2, 0, 1)
        b = np.array(node["b"], dtype=np.float32)
        if w.shape != tuple(mod.weight.shape) or b.shape != tuple(mod.bias.shape):
            raise ValueError(
                f"{path}: tree shapes {w.shape}/{b.shape} do not match the "
                f"module's {tuple(mod.weight.shape)}/{tuple(mod.bias.shape)}"
            )
        mod.weight.copy_(torch.from_numpy(np.ascontiguousarray(w)))
        mod.bias.copy_(torch.from_numpy(b))

    layers = tree["layers"]
    for name, mod in model.layers.items():
        if name not in layers:
            raise KeyError(f"layers.{name} missing from the params tree")
        _walk(mod, layers[name], load, f"layers.{name}")
    return model


def params_to_tree(model: YoloModel) -> Dict:
    """The module's weights as a JAX-layout params tree (numpy fp32, HWIO)."""

    def build(module: nn.Module):
        if isinstance(module, ConvAct):
            return {
                "w": module.weight.detach().float().cpu().numpy().transpose(2, 3, 1, 0).copy(),
                "b": module.bias.detach().float().cpu().numpy().copy(),
            }
        if isinstance(module, nn.ModuleList):
            return [build(sub) for sub in module]
        return {name: build(sub) for name, sub in module.named_children()}

    return {"layers": {name: build(mod) for name, mod in model.layers.items()}}


def synthetic_params(model: YoloModel, seed: int = 0) -> Dict:
    """Seeded He-scaled weights with BatchNorm statistics folded in, as a
    params tree for ``model`` — the recipe of
    scripts/gen_golden_fixture.py::synthetic_weights, so activations survive
    every layer and detections depend on the input (a random init with
    class biases at log(0.01/0.99) keeps every score near 0.01). The head's
    plain output convs carry no BatchNorm."""
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
        else:
            for v in (node.values() if isinstance(node, dict) else node):
                fill(v)

    fill(tree)
    head = tree["layers"][str(model.head_idx)]
    for branch in (head["cv2"], head["cv3"]):
        for level in branch:
            conv(level[2], bn=False)
    return tree


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
    """Map an Ultralytics-layout v8 state dict onto the params tree."""
    layers: Dict[str, Dict] = {}
    for i, node in enumerate(model.nodes):
        base = f"{prefix}{i}"
        if node.kind == "conv":
            layers[str(i)] = _conv_block(sd, base)
        elif node.kind == "c2f":
            layers[str(i)] = {
                "cv1": _conv_block(sd, f"{base}.cv1"),
                "cv2": _conv_block(sd, f"{base}.cv2"),
                "m": [_bottleneck(sd, f"{base}.m.{j}") for j in range(node.n)],
            }
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
    return {"layers": layers}


def load_yolo_checkpoint(model: YoloModel, path: str) -> Optional[Dict]:
    """Best-effort load of a YOLO checkpoint file into a params tree.
    Returns None when the file is missing, unreadable or of another layout."""
    if str(path).endswith(".onnx"):
        raise NotImplementedError(
            "weights-.onnx checkpoints need the ONNX initializer reader, "
            "which is not ported to the PyTorch package yet (ROADMAP.md); "
            "convert to .pt or a flat .npz"
        )
    try:
        sd = _read_state_dict(path)
    except Exception as exc:  # noqa: BLE001 — any unreadable file -> None
        logger.warning("Could not read checkpoint %s: %s", path, exc)
        return None
    if sd is None:
        return None
    if "__pytree__" in sd:
        params = sd["__pytree__"].item()
        if _tree_shapes(params) != _tree_shapes(params_to_tree(model)):
            logger.warning("pytree checkpoint %s does not match the model", path)
            return None
        return params
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
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        for key in ("state_dict", "model"):
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
