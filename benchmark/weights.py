"""Seeded checkpoints in the published Ultralytics YOLOv8 layout.

``yolov8_manifest`` is a frozen copy of the published state dict's keys and
shapes (``ultralytics/cfg/models/v8/yolov8.yaml`` and the modules of
``ultralytics/nn/modules``: ``Conv``, ``C2f``, ``SPPF``, ``Detect``), so the
benchmark owns the layout it measures. ``seeded_state_dict`` fills it on the
card from one ``torch.Generator`` in two large draws (a normal and a uniform
over every element), then splits and scales them key by key:

* a ``Conv``'s weight is He-scaled (std ``sqrt(2 / fan_in)``), its batch
  norm's gamma lies in [0.3, 0.5] and its beta is 0.5 with std 0.3, so
  that SiLU bends the signal without folding it: a deep random network
  with folded activations is chaotic, and its outputs would swing with the
  rounding of any precision;
* ``dfl.conv.weight`` is ``arange(16)``, as the published model fixes it;
* each batch norm's running mean and variance are then those of its conv's
  output on twelve seeded scenes (``frames.scene_frames``: four textured,
  eight flat with ``BOXES`` rectangles, as the cameras render them), layer
  after layer, as training leaves them: each layer's output keeps its scale
  through the depth, at every model scale, and the detections depend on
  the image;
* on the same scenes each output channel of the detect head's output convs
  is scaled to unit spread around zero, then offset by its bias: a normal of
  std 1 for the box logits, a normal of std ``CLASS_BIAS_STD`` for the class
  logits, all shifted by one number, found by bisection, so that the flat
  scenes keep ``DETECTIONS`` detections a frame on average after the
  engines' postprocess (confidence 0.25, top 1024, NMS at IoU 0.45).
  ``DETECTIONS`` is COCO's mean of 7.7 object instances an image (Lin et
  al., "Microsoft COCO: Common Objects in Context", ECCV 2014, section 5),
  the dataset whose 80 classes the detector serves; a scene draws that many
  rectangles, rounded up (``BOXES``). The pipeline's host work (tracker,
  sink) grows with the detections of a camera frame, so every seed gives it
  the same load, at scores that are not saturated.

The same seed gives the same checkpoint on any card. ``write_checkpoint``
saves it with ``torch.save`` as a flat state dict, under a file name whose
stem starts with ``yolov8<scale>`` (the engines read the scale from it).
"""

from __future__ import annotations

import math
import os
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .frames import scene_frames
from .reference.yolov8 import BN_EPS, Geometry, YoloV8, letterbox, postprocess

Shape = Tuple[int, ...]

REG_MAX = 16
DETECTIONS = 7.7  # COCO's object instances an image: what a flat scene keeps after NMS
BOXES = 8  # rectangles a scene draws: DETECTIONS rounded up
CLASS_BIAS_STD = 0.3
SCALES = {  # yolov8.yaml: depth, width, max channels
    "n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024), "m": (0.67, 0.75, 768),
    "l": (1.00, 1.00, 512), "x": (1.00, 1.25, 512),
}


def make_divisible(x: float, divisor: int = 8) -> int:
    return int(math.ceil(x / divisor) * divisor)


def _conv(prefix: str, cin: int, cout: int, k: int) -> Dict[str, Shape]:
    return {f"{prefix}.conv.weight": (cout, cin, k, k), f"{prefix}.bn.weight": (cout,),
            f"{prefix}.bn.bias": (cout,), f"{prefix}.bn.running_mean": (cout,),
            f"{prefix}.bn.running_var": (cout,), f"{prefix}.bn.num_batches_tracked": ()}


def _c2f(prefix: str, c1: int, c2: int, n: int) -> Dict[str, Shape]:
    c = int(c2 * 0.5)
    out = {**_conv(f"{prefix}.cv1", c1, 2 * c, 1), **_conv(f"{prefix}.cv2", (2 + n) * c, c2, 1)}
    for j in range(n):
        out.update(_conv(f"{prefix}.m.{j}.cv1", c, c, 3))
        out.update(_conv(f"{prefix}.m.{j}.cv2", c, c, 3))
    return out


def _detect(prefix: str, ch, nc: int) -> Dict[str, Shape]:
    c2, c3 = max(16, ch[0] // 4, REG_MAX * 4), max(ch[0], min(nc, 100))
    out: Dict[str, Shape] = {}
    for lvl, c in enumerate(ch):
        out.update(_conv(f"{prefix}.cv2.{lvl}.0", c, c2, 3))
        out.update(_conv(f"{prefix}.cv2.{lvl}.1", c2, c2, 3))
        out.update({f"{prefix}.cv2.{lvl}.2.weight": (4 * REG_MAX, c2, 1, 1),
                    f"{prefix}.cv2.{lvl}.2.bias": (4 * REG_MAX,)})
        out.update(_conv(f"{prefix}.cv3.{lvl}.0", c, c3, 3))
        out.update(_conv(f"{prefix}.cv3.{lvl}.1", c3, c3, 3))
        out.update({f"{prefix}.cv3.{lvl}.2.weight": (nc, c3, 1, 1),
                    f"{prefix}.cv3.{lvl}.2.bias": (nc,)})
    out[f"{prefix}.dfl.conv.weight"] = (1, REG_MAX, 1, 1)
    return out


def yolov8_manifest(scale: str = "n", nc: int = 80) -> Dict[str, Shape]:
    """Every key and shape of the published YOLOv8 state dict at ``scale``."""
    depth, width, max_ch = SCALES[scale]

    def ch(c: int) -> int:
        return make_divisible(min(c, max_ch) * width)

    def rep(n: int) -> int:
        return max(round(n * depth), 1)

    p = "model."
    sd: Dict[str, Shape] = {}
    sd.update(_conv(p + "0", 3, ch(64), 3))
    sd.update(_conv(p + "1", ch(64), ch(128), 3))
    sd.update(_c2f(p + "2", ch(128), ch(128), rep(3)))
    sd.update(_conv(p + "3", ch(128), ch(256), 3))
    sd.update(_c2f(p + "4", ch(256), ch(256), rep(6)))
    sd.update(_conv(p + "5", ch(256), ch(512), 3))
    sd.update(_c2f(p + "6", ch(512), ch(512), rep(6)))
    sd.update(_conv(p + "7", ch(512), ch(1024), 3))
    sd.update(_c2f(p + "8", ch(1024), ch(1024), rep(3)))
    sd.update(_conv(p + "9.cv1", ch(1024), ch(1024) // 2, 1))
    sd.update(_conv(p + "9.cv2", ch(1024) // 2 * 4, ch(1024), 1))
    sd.update(_c2f(p + "12", ch(512) + ch(1024), ch(512), rep(3)))
    sd.update(_c2f(p + "15", ch(256) + ch(512), ch(256), rep(3)))
    sd.update(_conv(p + "16", ch(256), ch(256), 3))
    sd.update(_c2f(p + "18", ch(256) + ch(512), ch(512), rep(3)))
    sd.update(_conv(p + "19", ch(512), ch(512), 3))
    sd.update(_c2f(p + "21", ch(512) + ch(1024), ch(1024), rep(3)))
    sd.update(_detect(p + "22", [ch(256), ch(512), ch(1024)], nc))
    return sd


def _fill(key: str, shape: Shape, normal: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """One tensor of the checkpoint from its slices of the two draws."""
    if key.endswith("num_batches_tracked"):
        return torch.zeros((), dtype=torch.long)
    if key.endswith("dfl.conv.weight"):
        return torch.arange(REG_MAX, dtype=torch.float32).view(shape)
    n, u = normal.view(shape), uniform.view(shape)
    if key.endswith(".bn.weight"):
        return 0.3 + 0.2 * u
    if key.endswith(".bn.bias"):
        return 0.5 + 0.3 * n
    if key.endswith(".bn.running_mean"):
        return torch.zeros(shape)
    if key.endswith(".bn.running_var"):
        return torch.ones(shape)
    if key.endswith(".bias"):  # the head's output convs
        return CLASS_BIAS_STD * n if ".cv3." in key else n
    fan_in = math.prod(shape[1:])
    return n * math.sqrt(2.0 / fan_in)


def seeded_state_dict(scale: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """The checkpoint of ``scale`` for ``seed``, as fp32 tensors on ``device``."""
    manifest = yolov8_manifest(scale)
    sizes = [math.prod(s) for s in manifest.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    normal = torch.randn(sum(sizes), generator=gen, device=device)
    uniform = torch.rand(sum(sizes), generator=gen, device=device)
    sd, at = {}, 0
    for (key, shape), size in zip(manifest.items(), sizes):
        t = _fill(key, shape, normal[at:at + size], uniform[at:at + size])
        sd[key] = t.to(device) if t.dtype == torch.float32 else t
        at += size
    frames = torch.cat([scene_frames(gen, 4, device), scene_frames(
        gen, 8, device, boxes=BOXES, field=0, noise=0, sizes=(0.08, 0.2))])
    with torch.no_grad():
        outs = _Calibrating(sd).levels(letterbox(frames, Geometry.of(*frames.shape[1:3])))
        shift = _detection_shift(_Calibrating(sd), [o[4:] for o in outs])
        for lvl in range(len(outs)):
            sd[f"model.22.cv3.{lvl}.2.bias"] += shift
    return sd


def _detection_shift(model: YoloV8, outs, steps: int = 16) -> float:
    """The class-logit shift at which the frames of ``outs`` keep
    ``DETECTIONS`` detections a frame on average (bisection)."""
    boxes, _ = model.decode(outs)
    logits = torch.cat([o[:, 4 * REG_MAX:].flatten(2) for o in outs], 2).transpose(1, 2)
    geo = Geometry.of(640, 640)

    def kept(shift: float) -> float:
        probs = torch.sigmoid(logits + shift)
        return sum(len(postprocess(b, p, geo, 0.25, 0.45, 1024, 300).scores)
                   for b, p in zip(boxes, probs)) / len(boxes)

    lo, hi = -20.0, 20.0
    for _ in range(steps):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if kept(mid) < DETECTIONS else (lo, mid)
    return (lo + hi) / 2


class _Calibrating(YoloV8):
    """The reference network run with each batch norm in training mode: its
    running statistics are set, in place in the state dict, to those of its
    conv's output on the batch, before the next layer reads it; the head's
    output convs are normalised on the batch before their bias is added."""

    def __init__(self, sd: Dict[str, torch.Tensor]):
        self.sd = sd
        self.convs = {k[: -len(".conv.weight")]: None for k in sd
                      if k.endswith(".conv.weight") and not k.endswith("dfl.conv.weight")}
        self.reg_max = sd["model.22.dfl.conv.weight"].shape[1]

    def head_conv(self, x: torch.Tensor, p: str) -> torch.Tensor:
        w, b = self.sd[p + ".weight"], self.sd[p + ".bias"]
        z = F.conv2d(x, w)
        mean, std = z.mean((0, 2, 3)), z.std((0, 2, 3))
        w.div_(std[:, None, None, None])
        b.sub_(mean / std)
        return F.conv2d(x, w, b)

    def conv(self, x: torch.Tensor, p: str, stride: int = 1) -> torch.Tensor:
        w = self.sd[p + ".conv.weight"]
        z = F.conv2d(x, w, None, stride=stride, padding=w.shape[-1] // 2)
        mean, var = z.mean((0, 2, 3)), z.var((0, 2, 3), unbiased=False)
        self.sd[p + ".bn.running_mean"].copy_(mean)
        self.sd[p + ".bn.running_var"].copy_(var)
        scale = self.sd[p + ".bn.weight"] / torch.sqrt(var + BN_EPS)
        shift = self.sd[p + ".bn.bias"] - mean * scale
        return F.silu(z * scale[:, None, None] + shift[:, None, None])


def write_checkpoint(sd: Dict[str, torch.Tensor], directory: str, scale: str,
                     seed: int) -> str:
    """Save ``sd`` as ``yolov8<scale>-seed<seed>.pt`` in ``directory``."""
    path = os.path.join(directory, f"yolov8{scale}-seed{seed}.pt")
    torch.save({k: v.cpu() for k, v in sd.items()}, path)
    return path
