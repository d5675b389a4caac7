"""Generate the published Ultralytics key->shape manifests.

These manifests are the loader's fidelity gate: they are written from the
*published* Ultralytics architecture specs (ultralytics/cfg/models/v8/
yolov8.yaml and ultralytics/cfg/models/v5/yolov5.yaml plus the module
definitions in ultralytics/nn/modules — Conv, C2f, C3, SPPF, Detect) and
torch's state_dict naming conventions. They deliberately share NO code with
either package's ``models/yolo.py``: if our graph spec deviates from
published Ultralytics (channel widths, head dims, block internals), the
manifest test fails — the torch-mirror fidelity tests alone cannot catch
that class of error because the mirror is assembled from our own graph spec
(round-1 VERDICT missing #2).

The port's copy of ``scripts/gen_yolo_manifest.py`` (numpy only; the port
imports nothing of the root ``scripts/``): the same manifests, which
``scripts/bench.py`` fills with seeded values for its synthetic checkpoint.

Usage: python -m realtime_analytics_tpu_torch.scripts.gen_yolo_manifest
(writes build/manifests/*.json in the checkout)
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Tuple

Shape = Tuple[int, ...]


def make_divisible(x: float, divisor: int = 8) -> int:
    """Ultralytics channel rounding (utils/ops: make_divisible)."""
    return int(math.ceil(x / divisor) * divisor)


# ---------------------------------------------------------------------------
# torch state-dict naming of the published Ultralytics modules
# ---------------------------------------------------------------------------


def conv_keys(prefix: str, cin: int, cout: int, k: int) -> Dict[str, Shape]:
    """ultralytics.nn.modules.conv.Conv = Conv2d(bias=False) + BatchNorm2d."""
    return {
        f"{prefix}.conv.weight": (cout, cin, k, k),
        f"{prefix}.bn.weight": (cout,),
        f"{prefix}.bn.bias": (cout,),
        f"{prefix}.bn.running_mean": (cout,),
        f"{prefix}.bn.running_var": (cout,),
        f"{prefix}.bn.num_batches_tracked": (),
    }


def conv2d_keys(prefix: str, cin: int, cout: int, k: int) -> Dict[str, Shape]:
    """Plain nn.Conv2d with bias (detect-head output convs)."""
    return {
        f"{prefix}.weight": (cout, cin, k, k),
        f"{prefix}.bias": (cout,),
    }


def bottleneck_v8_keys(prefix: str, c: int) -> Dict[str, Shape]:
    """C2f Bottleneck: cv1 = Conv(c, c, 3), cv2 = Conv(c, c, 3)."""
    out = {}
    out.update(conv_keys(f"{prefix}.cv1", c, c, 3))
    out.update(conv_keys(f"{prefix}.cv2", c, c, 3))
    return out


def c2f_keys(prefix: str, c1: int, c2: int, n: int) -> Dict[str, Shape]:
    """C2f: cv1 = Conv(c1, 2c, 1); cv2 = Conv((2+n)c, c2, 1); n Bottlenecks.
    Hidden c = int(c2 * 0.5)."""
    c = int(c2 * 0.5)
    out = {}
    out.update(conv_keys(f"{prefix}.cv1", c1, 2 * c, 1))
    out.update(conv_keys(f"{prefix}.cv2", (2 + n) * c, c2, 1))
    for j in range(n):
        out.update(bottleneck_v8_keys(f"{prefix}.m.{j}", c))
    return out


def bottleneck_v5_keys(prefix: str, c: int) -> Dict[str, Shape]:
    """C3 Bottleneck: cv1 = Conv(c, c, 1), cv2 = Conv(c, c, 3)."""
    out = {}
    out.update(conv_keys(f"{prefix}.cv1", c, c, 1))
    out.update(conv_keys(f"{prefix}.cv2", c, c, 3))
    return out


def c3_keys(prefix: str, c1: int, c2: int, n: int) -> Dict[str, Shape]:
    """C3: cv1/cv2 = Conv(c1, c, 1); cv3 = Conv(2c, c2, 1); n Bottlenecks."""
    c = int(c2 * 0.5)
    out = {}
    out.update(conv_keys(f"{prefix}.cv1", c1, c, 1))
    out.update(conv_keys(f"{prefix}.cv2", c1, c, 1))
    out.update(conv_keys(f"{prefix}.cv3", 2 * c, c2, 1))
    for j in range(n):
        out.update(bottleneck_v5_keys(f"{prefix}.m.{j}", c))
    return out


def sppf_keys(prefix: str, c1: int, c2: int) -> Dict[str, Shape]:
    """SPPF: cv1 = Conv(c1, c1//2, 1); cv2 = Conv(4 * c1//2, c2, 1)."""
    c = c1 // 2
    out = {}
    out.update(conv_keys(f"{prefix}.cv1", c1, c, 1))
    out.update(conv_keys(f"{prefix}.cv2", c * 4, c2, 1))
    return out


def detect_v8_keys(prefix: str, ch: List[int], nc: int, reg_max: int = 16
                   ) -> Dict[str, Shape]:
    """Detect (v8): per level, cv2 = box branch Sequential(Conv, Conv,
    Conv2d(4*reg_max)); cv3 = cls branch Sequential(Conv, Conv, Conv2d(nc));
    plus the fixed DFL projection conv.

    c2 = max(16, ch[0] // 4, reg_max * 4); c3 = max(ch[0], min(nc, 100)).
    """
    c2 = max(16, ch[0] // 4, reg_max * 4)
    c3 = max(ch[0], min(nc, 100))
    out: Dict[str, Shape] = {}
    for lvl, c in enumerate(ch):
        out.update(conv_keys(f"{prefix}.cv2.{lvl}.0", c, c2, 3))
        out.update(conv_keys(f"{prefix}.cv2.{lvl}.1", c2, c2, 3))
        out.update(conv2d_keys(f"{prefix}.cv2.{lvl}.2", c2, 4 * reg_max, 1))
        out.update(conv_keys(f"{prefix}.cv3.{lvl}.0", c, c3, 3))
        out.update(conv_keys(f"{prefix}.cv3.{lvl}.1", c3, c3, 3))
        out.update(conv2d_keys(f"{prefix}.cv3.{lvl}.2", c3, nc, 1))
    out[f"{prefix}.dfl.conv.weight"] = (1, reg_max, 1, 1)
    return out


def detect_v5_keys(prefix: str, ch: List[int], nc: int, na: int = 3
                   ) -> Dict[str, Shape]:
    """Detect (v5): one plain Conv2d(c, na*(nc+5), 1) per level, plus the
    registered anchor buffers."""
    out: Dict[str, Shape] = {}
    for lvl, c in enumerate(ch):
        out.update(conv2d_keys(f"{prefix}.m.{lvl}", c, na * (nc + 5), 1))
    out[f"{prefix}.anchors"] = (len(ch), na, 2)
    return out


# ---------------------------------------------------------------------------
# The published layer tables (yolov8.yaml / yolov5.yaml), scale "n"
# ---------------------------------------------------------------------------


def yolov8_manifest(size: str = "n", nc: int = 80) -> Dict[str, Shape]:
    depth, width, max_ch = {
        "n": (0.33, 0.25, 1024), "s": (0.33, 0.50, 1024),
        "m": (0.67, 0.75, 768), "l": (1.00, 1.00, 512),
        "x": (1.00, 1.25, 512),
    }[size]

    def ch(c: int) -> int:
        return make_divisible(min(c, max_ch) * width)

    def rep(n: int) -> int:
        return max(round(n * depth), 1)

    p = "model."
    sd: Dict[str, Shape] = {}
    # backbone (yolov8.yaml lines 14-25)
    sd.update(conv_keys(p + "0", 3, ch(64), 3))                    # P1/2
    sd.update(conv_keys(p + "1", ch(64), ch(128), 3))              # P2/4
    sd.update(c2f_keys(p + "2", ch(128), ch(128), rep(3)))
    sd.update(conv_keys(p + "3", ch(128), ch(256), 3))             # P3/8
    sd.update(c2f_keys(p + "4", ch(256), ch(256), rep(6)))
    sd.update(conv_keys(p + "5", ch(256), ch(512), 3))             # P4/16
    sd.update(c2f_keys(p + "6", ch(512), ch(512), rep(6)))
    sd.update(conv_keys(p + "7", ch(512), ch(1024), 3))            # P5/32
    sd.update(c2f_keys(p + "8", ch(1024), ch(1024), rep(3)))
    sd.update(sppf_keys(p + "9", ch(1024), ch(1024)))
    # head (yolov8.yaml lines 27-44); 10/13 upsample, 11/14/17/20 concat
    sd.update(c2f_keys(p + "12", ch(512) + ch(1024), ch(512), rep(3)))
    sd.update(c2f_keys(p + "15", ch(256) + ch(512), ch(256), rep(3)))
    sd.update(conv_keys(p + "16", ch(256), ch(256), 3))
    sd.update(c2f_keys(p + "18", ch(256) + ch(512), ch(512), rep(3)))
    sd.update(conv_keys(p + "19", ch(512), ch(512), 3))
    sd.update(c2f_keys(p + "21", ch(512) + ch(1024), ch(1024), rep(3)))
    sd.update(detect_v8_keys(p + "22", [ch(256), ch(512), ch(1024)], nc))
    return sd


def yolov5_manifest(size: str = "n", nc: int = 80) -> Dict[str, Shape]:
    depth, width = {
        "n": (0.33, 0.25), "s": (0.33, 0.50), "m": (0.67, 0.75),
        "l": (1.00, 1.00), "x": (1.33, 1.25),
    }[size]

    def ch(c: int) -> int:
        return make_divisible(c * width)

    def rep(n: int) -> int:
        return max(round(n * depth), 1)

    p = "model."
    sd: Dict[str, Shape] = {}
    # backbone (yolov5.yaml v6.0: 6x6 stem conv)
    sd.update(conv_keys(p + "0", 3, ch(64), 6))                    # P1/2
    sd.update(conv_keys(p + "1", ch(64), ch(128), 3))              # P2/4
    sd.update(c3_keys(p + "2", ch(128), ch(128), rep(3)))
    sd.update(conv_keys(p + "3", ch(128), ch(256), 3))             # P3/8
    sd.update(c3_keys(p + "4", ch(256), ch(256), rep(6)))
    sd.update(conv_keys(p + "5", ch(256), ch(512), 3))             # P4/16
    sd.update(c3_keys(p + "6", ch(512), ch(512), rep(9)))
    sd.update(conv_keys(p + "7", ch(512), ch(1024), 3))            # P5/32
    sd.update(c3_keys(p + "8", ch(1024), ch(1024), rep(3)))
    sd.update(sppf_keys(p + "9", ch(1024), ch(1024)))
    # head; 11/15 upsample, 12/16/19/22 concat
    sd.update(conv_keys(p + "10", ch(1024), ch(512), 1))
    sd.update(c3_keys(p + "13", ch(512) + ch(512), ch(512), rep(3)))
    sd.update(conv_keys(p + "14", ch(512), ch(256), 1))
    sd.update(c3_keys(p + "17", ch(256) + ch(256), ch(256), rep(3)))
    sd.update(conv_keys(p + "18", ch(256), ch(256), 3))
    sd.update(c3_keys(p + "20", ch(256) + ch(256), ch(512), rep(3)))
    sd.update(conv_keys(p + "21", ch(512), ch(512), 3))
    sd.update(c3_keys(p + "23", ch(512) + ch(512), ch(1024), rep(3)))
    sd.update(detect_v5_keys(p + "24", [ch(256), ch(512), ch(1024)], nc))
    return sd


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    out_dir = os.path.join(here, "build", "manifests")
    os.makedirs(out_dir, exist_ok=True)
    for name, manifest in (
        ("yolov8n", yolov8_manifest("n")),
        ("yolov8s", yolov8_manifest("s")),
        ("yolov5n", yolov5_manifest("n")),
        ("yolov5s", yolov5_manifest("s")),
    ):
        path = os.path.join(out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump({k: list(v) for k, v in manifest.items()}, f, indent=0,
                      sort_keys=True)
            f.write("\n")
        print(f"{name}: {len(manifest)} keys -> {path}")


if __name__ == "__main__":
    main()
