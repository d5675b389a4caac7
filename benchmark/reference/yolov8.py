"""Plain fp32 YOLOv8 detector: the reference the benchmark holds the port to.

Written from the published model (``ultralytics/cfg/models/v8/yolov8.yaml``
and ``ultralytics/nn/modules``), in plain ``torch`` operations on an
Ultralytics state dict: ``Conv`` (conv, BatchNorm with eps 1e-3, SiLU),
``C2f``, ``SPPF``, nearest 2x upsampling, ``Detect`` with its DFL. Every
width and depth is read from the state dict's shapes, so one function serves
every scale. It imports nothing of the program, and is computed in fp32 with
TF32 off (``tf32_off``).

Around the network, the serving semantics the engines state:

* letterbox: scale ``min(640 / W, 640 / H)``, bilinear with half-pixel
  centres (as ``cv2.INTER_LINEAR``), rounded to uint8, centred on a 114 pad;
  BGR to RGB, / 255;
* candidates: an anchor's confidence is its best class probability, kept at
  ``conf >= confidence_threshold``; the ``pre_nms_topk`` best (ties to the
  lower anchor) enter class-agnostic greedy NMS, which drops a box whose IoU
  with a kept, better-ranked box is over ``iou_threshold``; the first
  ``max_detections`` kept remain;
* boxes go back to frame pixels and are clipped to ``[0, W - 1]`` and
  ``[0, H - 1]``.

``anchors`` gives every anchor's box (frame pixels) and class probabilities,
which the comparison reads; ``detections`` the postprocessed result.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-3
STRIDES = (8, 16, 32)
PAD_VALUE = 114


@contextlib.contextmanager
def tf32_off():
    """fp32 convolutions and matmuls in full fp32 for the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@dataclass(frozen=True)
class Geometry:
    """The letterbox of one source size into the model's square input."""

    src_h: int
    src_w: int
    size: int
    scale: float
    new_h: int
    new_w: int
    top: int
    left: int

    @classmethod
    def of(cls, src_h: int, src_w: int, size: int = 640) -> "Geometry":
        r = min(size / src_h, size / src_w)
        new_h, new_w = int(round(src_h * r)), int(round(src_w * r))
        top = int(round((size - new_h) / 2 - 0.1))
        left = int(round((size - new_w) / 2 - 0.1))
        return cls(src_h, src_w, size, r, new_h, new_w, top, left)


def letterbox(frames: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """uint8 BGR [N, H, W, 3] -> fp32 RGB [N, 3, size, size] in [0, 1]."""
    x = frames.permute(0, 3, 1, 2).to(torch.float32)
    if (geo.new_h, geo.new_w) != (geo.src_h, geo.src_w):
        x = F.interpolate(x, size=(geo.new_h, geo.new_w), mode="bilinear",
                          align_corners=False, antialias=False)
        x = x.round().clamp(0, 255)
    out = torch.full((x.shape[0], 3, geo.size, geo.size), float(PAD_VALUE),
                     dtype=torch.float32, device=x.device)
    out[:, :, geo.top:geo.top + geo.new_h, geo.left:geo.left + geo.new_w] = x
    return out.flip(1) / 255.0


class YoloV8:
    """The network over a state dict (``model.<i>.…`` keys), BatchNorm folded
    into each conv once, in fp32."""

    def __init__(self, sd: Dict[str, torch.Tensor], device):
        self.sd = {k: v.to(device=device, dtype=torch.float32) for k, v in sd.items()
                   if not k.endswith("num_batches_tracked")}
        self.convs: Dict[str, tuple] = {}
        for key in self.sd:
            if key.endswith(".conv.weight") and not key.endswith("dfl.conv.weight"):
                p = key[: -len(".conv.weight")]
                w = self.sd[key]
                g, b = self.sd[p + ".bn.weight"], self.sd[p + ".bn.bias"]
                m, v = self.sd[p + ".bn.running_mean"], self.sd[p + ".bn.running_var"]
                s = g / torch.sqrt(v + BN_EPS)
                self.convs[p] = (w * s[:, None, None, None], b - m * s)
        self.nc = self.sd["model.22.cv3.0.2.bias"].shape[0]
        self.reg_max = self.sd["model.22.dfl.conv.weight"].shape[1]

    def conv(self, x: torch.Tensor, p: str, stride: int = 1) -> torch.Tensor:
        w, b = self.convs[p]
        return F.silu(F.conv2d(x, w, b, stride=stride, padding=w.shape[-1] // 2))

    def head_conv(self, x: torch.Tensor, p: str) -> torch.Tensor:
        """The detect head's plain output conv (bias, no activation)."""
        return F.conv2d(x, self.sd[p + ".weight"], self.sd[p + ".bias"])

    def c2f(self, x: torch.Tensor, p: str, shortcut: bool) -> torch.Tensor:
        y = list(self.conv(x, p + ".cv1").chunk(2, dim=1))
        j = 0
        while f"{p}.m.{j}.cv1" in self.convs:
            h = self.conv(self.conv(y[-1], f"{p}.m.{j}.cv1"), f"{p}.m.{j}.cv2")
            y.append(y[-1] + h if shortcut else h)
            j += 1
        return self.conv(torch.cat(y, dim=1), p + ".cv2")

    def sppf(self, x: torch.Tensor, p: str) -> torch.Tensor:
        y = [self.conv(x, p + ".cv1")]
        for _ in range(3):
            y.append(F.max_pool2d(y[-1], kernel_size=5, stride=1, padding=2))
        return self.conv(torch.cat(y, dim=1), p + ".cv2")

    def levels(self, x: torch.Tensor) -> List[torch.Tensor]:
        """[N, 3, S, S] -> the head's outputs [N, 4 * reg_max + nc, h, w] a level."""
        p = "model."
        up = lambda t: F.interpolate(t, scale_factor=2.0, mode="nearest")  # noqa: E731
        x = self.conv(x, p + "0", 2)
        x = self.conv(x, p + "1", 2)
        x = self.c2f(x, p + "2", True)
        x = self.conv(x, p + "3", 2)
        p3 = self.c2f(x, p + "4", True)
        x = self.conv(p3, p + "5", 2)
        p4 = self.c2f(x, p + "6", True)
        x = self.conv(p4, p + "7", 2)
        x = self.c2f(x, p + "8", True)
        p5 = self.sppf(x, p + "9")
        h12 = self.c2f(torch.cat([up(p5), p4], 1), p + "12", False)
        h15 = self.c2f(torch.cat([up(h12), p3], 1), p + "15", False)
        h18 = self.c2f(torch.cat([self.conv(h15, p + "16", 2), h12], 1), p + "18", False)
        h21 = self.c2f(torch.cat([self.conv(h18, p + "19", 2), p5], 1), p + "21", False)
        outs = []
        for lvl, t in enumerate((h15, h18, h21)):
            d = f"{p}22"
            box = self.conv(self.conv(t, f"{d}.cv2.{lvl}.0"), f"{d}.cv2.{lvl}.1")
            box = self.head_conv(box, f"{d}.cv2.{lvl}.2")
            cls = self.conv(self.conv(t, f"{d}.cv3.{lvl}.0"), f"{d}.cv3.{lvl}.1")
            cls = self.head_conv(cls, f"{d}.cv3.{lvl}.2")
            outs.append(torch.cat([box, cls], 1))
        return outs

    def decode(self, outs: List[torch.Tensor]):
        """Head outputs -> (boxes [N, A, 4] xyxy input pixels, probs [N, A, nc])."""
        n, r = outs[0].shape[0], self.reg_max
        flat = torch.cat([o.flatten(2) for o in outs], 2)  # [N, C, A]
        anchors, strides = [], []
        for o, s in zip(outs, STRIDES):
            h, w = o.shape[2:]
            sy, sx = torch.meshgrid(torch.arange(h, device=o.device) + 0.5,
                                    torch.arange(w, device=o.device) + 0.5, indexing="ij")
            anchors.append(torch.stack([sx, sy], -1).view(-1, 2))
            strides.append(torch.full((h * w, 1), float(s), device=o.device))
        anchors, strides = torch.cat(anchors).T[None], torch.cat(strides).T[None]
        dist = flat[:, : 4 * r].view(n, 4, r, -1).softmax(2)
        dist = F.conv2d(dist.transpose(1, 2), self.sd["model.22.dfl.conv.weight"]).view(n, 4, -1)
        lt, rb = dist.chunk(2, 1)
        boxes = torch.cat([anchors - lt, anchors + rb], 1) * strides
        probs = flat[:, 4 * r:].sigmoid()
        return boxes.transpose(1, 2), probs.transpose(1, 2)


def to_frame(boxes: torch.Tensor, geo: Geometry) -> torch.Tensor:
    """Input-pixel xyxy -> frame pixels, clipped to the frame."""
    x = ((boxes[..., 0::2] - geo.left) / geo.scale).clamp(0.0, geo.src_w - 1.0)
    y = ((boxes[..., 1::2] - geo.top) / geo.scale).clamp(0.0, geo.src_h - 1.0)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], -1)


def iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of xyxy boxes a [..., M, 4] against b [..., K, 4]."""
    area_a = (a[..., 2] - a[..., 0]).clamp(min=0) * (a[..., 3] - a[..., 1]).clamp(min=0)
    area_b = (b[..., 2] - b[..., 0]).clamp(min=0) * (b[..., 3] - b[..., 1]).clamp(min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    inter = (rb - lt).clamp(min=0).prod(-1)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


@dataclass
class Anchors:
    """Every anchor of one frame: boxes [A, 4] in frame pixels, probs [A, nc]."""

    boxes: torch.Tensor
    probs: torch.Tensor


@dataclass
class Detections:
    """Postprocessed detections of one frame (numpy)."""

    boxes: np.ndarray  # [D, 4] frame pixels
    scores: np.ndarray  # [D]
    classes: np.ndarray  # [D]
    cut: float  # the score a detection must exceed to be sure of its place (see ``postprocess``)
    inside: np.ndarray  # [D] bool: the box lay inside the frame before the clip


def postprocess(boxes: torch.Tensor, probs: torch.Tensor, geo: Geometry, conf_thr: float,
                iou_thr: float, topk: int, max_det: int) -> Detections:
    """One frame's candidates -> its detections, as the engines state them.
    ``cut`` is the highest score at which a threshold, the top-k or the
    ``max_det`` limit cut candidates: a detection above it is in the result
    whatever the order of near ties below it."""
    conf, cls = probs.max(1)
    conf = torch.where(conf >= conf_thr, conf, torch.zeros_like(conf))
    order = torch.sort(conf, descending=True, stable=True).indices[:topk]
    s, b, c = conf[order], boxes[order], cls[order]
    valid = (s > 0).cpu().numpy()
    over = (iou_matrix(b, b) > iou_thr).cpu().numpy()
    keep = np.zeros(len(order), bool)
    for i in range(len(order)):
        if valid[i] and not (over[i, :i] & keep[:i]).any():
            keep[i] = True
    kept = np.flatnonzero(keep)[:max_det]
    s_np = s.cpu().numpy()
    cut = conf_thr
    if len(order) < conf.shape[0]:
        cut = max(cut, float(s_np[-1]))
    if keep.sum() >= max_det:
        cut = max(cut, float(s_np[kept[-1]]))
    kb = b[kept]
    fb = to_frame(kb, geo)
    x = (kb[:, 0::2] - geo.left) / geo.scale
    y = (kb[:, 1::2] - geo.top) / geo.scale
    inside = (x >= 0).all(1) & (x <= geo.src_w - 1).all(1) & (y >= 0).all(1) & (y <= geo.src_h - 1).all(1)
    return Detections(fb.cpu().numpy(), s_np[kept], c[kept].cpu().numpy(), cut,
                      inside.cpu().numpy())


def run(model: YoloV8, frames: torch.Tensor, conf_thr: float, iou_thr: float, topk: int,
        max_det: int, size: int = 640, block: int = 8):
    """Frames [N, H, W, 3] uint8 BGR (any device) -> ([Anchors], [Detections])
    a frame, computed ``block`` frames at a time on the model's device."""
    geo = Geometry.of(frames.shape[1], frames.shape[2], size)
    device = next(iter(model.sd.values())).device
    anchors, dets = [], []
    with torch.inference_mode(), tf32_off():
        for lo in range(0, frames.shape[0], block):
            x = letterbox(frames[lo:lo + block].to(device), geo)
            boxes, probs = model.decode(model.levels(x))
            for i in range(boxes.shape[0]):
                anchors.append(Anchors(to_frame(boxes[i], geo), probs[i]))
                dets.append(postprocess(boxes[i], probs[i], geo, conf_thr, iou_thr, topk,
                                        max_det))
    return anchors, dets


def flops_per_image(sd: Dict[str, torch.Tensor], size: int = 640) -> float:
    """The network's FLOPs on one image, by ``torch.utils.flop_counter`` on
    the CPU (convolutions, two a multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode

    model = YoloV8({k: v.cpu() for k, v in sd.items()}, "cpu")
    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        model.levels(torch.zeros(1, 3, size, size))
    return float(counter.get_total_flops())


__all__ = ["Anchors", "Detections", "Geometry", "YoloV8", "flops_per_image", "iou_matrix",
           "letterbox", "postprocess", "run", "tf32_off", "to_frame"]
