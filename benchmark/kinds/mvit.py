"""MViTv2: what the benchmark does for a configuration whose ``kind`` is
``mvit``.

* ``checkpoint(ctx)``: seeded weights in PySlowFast's ``model_state``
  layout (``mvit_weights.py``, the layout of the network the configuration
  sizes in ``reference/mvit.py``), made on the device from ``ctx.seed``;
  their fp32 tensors stay on the host as ``ctx.state_dict`` for the
  reference, and the checkpoint goes to the work directory as PySlowFast
  saves one (``{"model_state": ...}``);
* ``detector_config(ctx, model_path, buckets, warmup)``: the program's
  ``DetectorConfig`` for ``TorchTemporalEngine`` (``model_type:
  mvitv2_s``): T, stride, crop, classes, precision, threshold;
* ``check(config, state_dict, samples, device)``: the logits the timed path
  served for each sampled clip against the plain fp32 reference
  (``reference/mvit.py``, built from the configuration, the state loaded
  strictly) on the same clip: ``logit_err``, the largest |served -
  reference| over a clip's logits over the standard deviation of that
  clip's reference logits, in % (the worst clip); ``logit_rms``, the same
  as a root mean square; ``clips``, the clips compared;
* ``passes(checks)``: at least one clip compared, no number over its limit;
* ``control(config)``: the control of the check, the program's weights
  rounded through ``float8_e4m3fn`` (the next precision below bf16) while
  the reference keeps fp32.
"""

from __future__ import annotations

import os
from typing import Dict

CONTROL_DTYPE = "float8_e4m3fn"


def checkpoint(ctx) -> str:
    import torch

    from benchmark.mvit_weights import seeded_state_dict

    sd = seeded_state_dict(ctx.config, ctx.seed, ctx.device)
    ctx.state_dict = {k: v.cpu() for k, v in sd.items()}
    served = ctx.state_dict
    if ctx.config.get("weights_rounding") == CONTROL_DTYPE:
        fp8 = getattr(torch, CONTROL_DTYPE)
        served = {k: v.to(fp8).float() if v.dim() >= 2 else v for k, v in served.items()}
    path = os.path.join(ctx.workdir, f"mvitv2_s-{ctx.seed}.pyth")
    torch.save({"model_state": served}, path)
    return path


def detector_config(ctx, model_path: str, buckets, warmup: bool):
    from realtime_analytics_tpu_torch.config import DetectorConfig

    c = ctx.config
    return DetectorConfig(
        model_path=model_path, model_type="mvitv2_s", device=ctx.device,
        confidence_threshold=c["confidence_threshold"],
        input_size=[c["crop_size"], c["crop_size"]], sequence_length=c["num_frames"],
        sequence_stride=c["sampling_rate"], num_action_classes=c["num_classes"],
        max_batch_size=max(buckets), batch_buckets=sorted(buckets),
        precision=c["precision"], warmup=warmup)


def readings(served, reference):
    """Per clip: (largest, root mean square) |served - reference| over the
    clip's reference logits' standard deviation, in %."""
    diff = (served - reference).abs()
    scale = reference.std(dim=1)
    return (100.0 * diff.amax(dim=1) / scale,
            100.0 * diff.pow(2).mean(dim=1).sqrt() / scale)


def check(config: Dict, state_dict, samples, device: str) -> Dict:
    """Each compared number's reading over the sampled clips, beside its
    limit. ``samples``: (key, clip uint8 [T, H, W, 3] BGR, served fp32
    logits [classes]); the reference runs once over each distinct key, 8
    clips at a time."""
    import numpy as np
    import torch

    from benchmark.reference.mvit import MViT, logits

    by_key: Dict = {}
    for s in samples:
        by_key.setdefault(s[0], []).append(s)
    keys = list(by_key)
    errs, rmss = [], []
    if keys:
        model = MViT(config, state_dict, device)
        for lo in range(0, len(keys), 8):
            block = keys[lo:lo + 8]
            clips = torch.from_numpy(np.stack([by_key[k][0][1] for k in block]))
            ref = logits(model, clips)
            for k, r in zip(block, ref):
                served = torch.from_numpy(np.stack([s[2] for s in by_key[k]])).float()
                err, rms = readings(served, r.expand_as(served))
                errs += err.tolist()
                rmss += rms.tolist()
        del model
    found = {"logit_err": max(errs, default=None), "logit_rms": max(rmss, default=None)}
    out = {name: {"value": found[name], "limit": limit}
           for name, limit in config["limits"].items()}
    out["clips"] = {"value": len(errs), "limit": 1}
    return out


def passes(checks: Dict) -> bool:
    ok = checks["clips"]["value"] >= checks["clips"]["limit"]
    return ok and all(c["value"] is None or c["value"] <= c["limit"]
                      for k, c in checks.items() if k != "clips")


def control(config: Dict) -> None:
    config["weights_rounding"] = CONTROL_DTYPE
