"""NumPy evaluator for torch-exported ONNX graphs — the fidelity oracle.

Round-3 verdict: the repo's checkpoint-fidelity gates compared the JAX
models against a torch *mirror* written by the same author — a shared
architectural misunderstanding would pass every gate. This executor breaks
that circularity: it topologically evaluates an ONNX **graph** (parsed by
``onnx_lite.read_onnx_model``) with plain numpy, so the reference output of
a fidelity test is torch's own export of the architecture (torch's
tracer + torch's operational semantics), with no code from this repo's model
definitions (``models/yolo.py``/``models/temporal.py``) or the test mirror
in the output path. The same executor runs *published* exports (e.g. an
Ultralytics ``yolov8n.onnx``) the moment one lands in the tree — the
backend-neutral interchange the reference itself trusts
(reference detector.py:484-609, its ONNX Runtime backend).

Scope: inference-mode CNN/RNN graphs as torch's TorchScript exporter emits
them (opset 10-17): explicit pads, static shapes after constant folding.
Covers 2-D and 3-D Conv/pooling and the ONNX LSTM/GRU recurrent nodes, so
every temporal family's export (cnn_lstm / conv_gru / 3d_cnn / slow_fast)
evaluates too. This is an oracle, not a serving path — clarity over speed;
the engines serve through ``models/onnx_torch.py``, which also folds every
all-constant node through ``_eval_node`` here.

The port's copy of ``realtime_analytics_tpu/models/onnx_exec.py`` (numpy
only): the PyTorch package imports nothing of the JAX package.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from .onnx_lite import OnnxGraph, OnnxNode, read_onnx_model

logger = logging.getLogger(__name__)

# ONNX TensorProto.DataType codes used by Cast / ConstantOfShape
_CAST_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 5: np.int16, 6: np.int32,
    7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


class UnsupportedOnnxOp(NotImplementedError):
    pass


def _convnd(x, w, b, strides, pads, dilations, groups, acc=np.float32):
    """[N, C, *spatial] x [M, C/g, *k] -> [N, M, *out] via windowed matmul,
    any spatial rank (2-D and 3-D convs both export as ONNX ``Conv``).
    Explicit ONNX pads: [*dim_begins, *dim_ends]. ``acc``: accumulation
    dtype — float32 for float convs, int64 for the exact integer
    accumulation ConvInteger/QLinearConv require (float32 loses bits past
    2^24, reachable at ~260 uint8*int8 taps)."""
    k = x.ndim - 2
    n = x.shape[0]
    m, cg = w.shape[0], w.shape[1]
    ks = w.shape[2:]
    begins, ends = pads[:k], pads[k:]
    if any(pads):
        x = np.pad(x, ((0, 0), (0, 0)) + tuple(zip(begins, ends)))
    # effective receptive field with dilation, then subsample the taps
    ek = tuple((ki - 1) * d + 1 for ki, d in zip(ks, dilations))
    v = sliding_window_view(x, ek, axis=tuple(range(2, 2 + k)))
    # [N, C, *out', *ek] -> stride the out dims, dilate the window taps
    idx = (slice(None),) * 2
    idx += tuple(slice(None, None, s) for s in strides)
    idx += tuple(slice(None, None, d) for d in dilations)
    v = v[idx]
    out_sp = v.shape[2 : 2 + k]
    taps = cg * int(np.prod(ks))
    out = np.empty((n, m) + out_sp, dtype=acc)
    mg = m // groups
    # [N, *out, cg, *ks] ordering for the column matmul
    perm = (0,) + tuple(range(2, 2 + k)) + (1,) + tuple(range(2 + k, 2 + 2 * k))
    dst = (0, k + 1) + tuple(range(1, k + 1))  # [N, *out, mg] -> [N, mg, *out]
    for g in range(groups):
        vg = v[:, g * cg : (g + 1) * cg]
        cols = vg.transpose(perm).reshape((n,) + out_sp + (taps,))
        wg = w[g * mg : (g + 1) * mg].reshape(mg, taps).T
        out[:, g * mg : (g + 1) * mg] = (
            cols.astype(acc) @ wg.astype(acc)
        ).transpose(dst)
    if b is not None:
        out += b.reshape((1, m) + (1,) * k)
    return out


def _conv_transpose_nd(x, w, b, strides, pads, out_pad, dilations, groups):
    """ONNX ``ConvTranspose`` ([N, C, *sp] x W [C, M/g, *k]) as the
    gradient-of-conv formulation: dilate the input by the stride (insert
    stride-1 zeros), pad each side by (k_eff - 1 - pad) (+ output_padding
    at the end), then run a stride-1 forward conv with the spatially
    flipped, io-transposed kernel. Matches torch nn.ConvTranspose{2,3}d."""
    k = x.ndim - 2
    c_in = x.shape[1]
    m_per_g = w.shape[1]
    ks = w.shape[2:]
    cg = c_in // groups
    # flip spatial taps, swap io per group: [C, M/g, *k] -> [g*M/g, C/g, *k]
    wf = w[(slice(None), slice(None)) + (slice(None, None, -1),) * k]
    wf = wf.reshape((groups, cg, m_per_g) + ks)
    wf = wf.transpose((0, 2, 1) + tuple(range(3, 3 + k)))
    wf = wf.reshape((groups * m_per_g, cg) + ks)
    # dilate input by stride: length (L-1)*s + 1
    sp_dil = tuple((sp - 1) * s + 1 for sp, s in zip(x.shape[2:], strides))
    xd = np.zeros(x.shape[:2] + sp_dil, dtype=x.dtype)
    xd[(slice(None), slice(None))
       + tuple(slice(None, None, s) for s in strides)] = x
    k_eff = tuple((ki - 1) * d_ + 1 for ki, d_ in zip(ks, dilations))
    conv_pads = (
        [ke - 1 - p for ke, p in zip(k_eff, pads[:k])]
        + [ke - 1 - p + op_ for ke, p, op_ in
           zip(k_eff, pads[k:], out_pad)]
    )
    if any(p < 0 for p in conv_pads):
        raise UnsupportedOnnxOp("ConvTranspose pads exceed kernel extent")
    return _convnd(xd, wf, b, [1] * k, conv_pads, dilations, groups)


def _qaxis(nd, scale, zp, axis):
    """ONNX Q/DQ scale + zero-point pair (scalar or 1-D per-axis),
    reshaped to broadcast against a rank-``nd`` tensor along ``axis``.
    Returns (float32 scale, int32 zero_point). The quantized-model
    interchange contract the reference's RKNN backend consumes
    pre-converted (reference detector.py:705-869)."""
    scale = np.asarray(scale, dtype=np.float32)
    zp32 = np.asarray(0 if zp is None else zp).astype(np.int32)
    if scale.ndim > 1:
        raise UnsupportedOnnxOp("blocked quantization (scale rank > 1)")
    if scale.ndim == 1 and scale.size > 1:
        shape = [1] * nd
        shape[axis if axis >= 0 else axis + nd] = scale.size
        scale = scale.reshape(shape)
        if zp32.size > 1:
            zp32 = zp32.reshape(shape)
    return scale, zp32


def _qscalar(v, what):
    """Require a scalar (or 1-element) quantization parameter."""
    a = np.asarray(v)
    if a.size != 1:
        raise UnsupportedOnnxOp(f"per-axis {what} is not supported here")
    return a.reshape(()).item()


def _matmul_int(a, b, azp, bzp):
    """Exact ``(a - a_zp) @ (b - b_zp)`` in int64. Zero points: scalar,
    or 1-D per-row of ``a`` / per-column of ``b`` (MatMulInteger)."""
    azp = np.asarray(azp, dtype=np.int64)
    bzp = np.asarray(bzp, dtype=np.int64)
    if azp.ndim == 1 and azp.size > 1:
        azp = azp.reshape(-1, 1)
    return (a.astype(np.int64) - azp) @ (b.astype(np.int64) - bzp)


def _conv_int(node, x, w, xzp, wzp):
    """Exact integer ``conv(x - x_zp, w - w_zp)``, int64 accumulation.
    Implicit padding pads x with x_zero_point per the ONNX spec —
    subtracting the zero point FIRST turns that into plain zero padding.
    ``w_zp`` may be per-output-channel (1-D)."""
    if x.ndim not in (4, 5):
        raise UnsupportedOnnxOp(f"{node.op_type} over {x.ndim - 2}D input")
    if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
        raise UnsupportedOnnxOp(f"{node.op_type} auto_pad")
    k = x.ndim - 2
    xzp = np.asarray(0 if xzp is None else xzp, dtype=np.int64)
    if xzp.size != 1:
        raise UnsupportedOnnxOp(f"{node.op_type} per-axis x_zero_point")
    wzp = np.asarray(0 if wzp is None else wzp, dtype=np.int64)
    if wzp.ndim == 1 and wzp.size > 1:
        wzp = wzp.reshape((-1,) + (1,) * (w.ndim - 1))
    return _convnd(
        x.astype(np.int64) - xzp,
        w.astype(np.int64) - wzp,
        None,
        _attr(node, "strides", [1] * k),
        _attr(node, "pads", [0] * (2 * k)),
        _attr(node, "dilations", [1] * k),
        int(_attr(node, "group", 1)),
        acc=np.int64,
    )


def _requant(acc, mul, yzp, qdt):
    """int accumulator -> quantized output: ``saturate(rint(acc * mul)
    + y_zp)``. float32 product on purpose — the jnp twin computes the
    same way on device, and bit-parity between the executors is the
    pinned contract."""
    info = np.iinfo(qdt)
    y = np.rint(acc.astype(np.float32) * mul) + yzp
    return np.clip(y, info.min, info.max).astype(qdt)


def _poolnd(x, kernel, strides, pads, ceil_mode, op, dilations=None):
    """Max/average pool over any spatial rank (2-D and 3-D). ``dilations``
    (MaxPool only): windows sample every d-th element; all output-size /
    ceil-mode math uses the effective extent (k-1)*d+1."""
    k = len(kernel)
    dils = list(dilations) if dilations is not None else [1] * k
    ek = [(kernel[i] - 1) * dils[i] + 1 for i in range(k)]
    in_sp = x.shape[2:]
    begins, ends = list(pads[:k]), list(pads[k:])
    ext = [0] * k  # ceil-mode extension (beyond the explicit pads)
    if ceil_mode:
        # extend padding so the last partial window is included
        for i in range(k):
            span = in_sp[i] + begins[i] + ends[i]
            r = (span - ek[i]) % strides[i]
            ext[i] = (-(span - ek[i]) % strides[i]) if r else 0
    fill = -np.inf if op == "max" else 0.0
    if any(begins) or any(e + x2 for e, x2 in zip(ends, ext)):
        x = np.pad(
            x,
            ((0, 0), (0, 0))
            + tuple((b_, e_ + x_) for b_, e_, x_ in zip(begins, ends, ext)),
            constant_values=fill,
        )
    stride_idx = (slice(None),) * 2 + tuple(
        slice(None, None, s) for s in strides
    )
    win_axes = tuple(range(-k, 0))
    v = sliding_window_view(x, ek, axis=tuple(range(2, 2 + k)))[stride_idx]
    if any(d != 1 for d in dils):
        # subsample inside each (effective-extent) window
        v = v[(Ellipsis,) + tuple(slice(None, None, d) for d in dils)]
    if ceil_mode:
        # torch/ONNX-runtime drop rule: a ceil-extended window whose START
        # lies entirely in the end padding is not emitted — the last
        # window must start before in + pad_begin
        trim = (slice(None),) * 2 + tuple(
            slice(0, sum(1 for i in range(v.shape[2 + d])
                         if i * strides[d] < in_sp[d] + begins[d]))
            for d in range(k)
        )
        v = v[trim]
    if op == "max":
        return v.max(axis=win_axes)
    # Average divisor (torch semantics, count_include_pad=True): the
    # EXPLICIT pads count toward the divisor, the ceil-mode extension does
    # NOT — torch divides each window by its count of positions inside the
    # explicitly-padded extent. A plain mean() over-counts the ceil
    # extension's zeros (verified vs torch AvgPool2d(ceil_mode=True)).
    if any(ext):
        ones = np.ones(
            (1, 1) + tuple(x.shape[2 + d] - ext[d] for d in range(k)), x.dtype
        )
        ones = np.pad(
            ones, ((0, 0), (0, 0)) + tuple((0, e) for e in ext)
        )
        cnt = sliding_window_view(
            ones, kernel, axis=tuple(range(2, 2 + k))
        )[stride_idx]
        cnt = cnt[(slice(None),) * 2 + tuple(slice(0, s) for s in v.shape[2 : 2 + k])]
        return v.sum(axis=win_axes) / cnt.sum(axis=win_axes)
    return v.mean(axis=win_axes)


def _resize(x, scales, sizes, mode, coord_mode, nearest_mode):
    if x.ndim != 4:
        raise UnsupportedOnnxOp(
            f"Resize over {x.ndim - 2} spatial dims (only 2-D supported)"
        )
    n, c, h, w = x.shape
    if sizes is not None and len(sizes):
        oh, ow = int(sizes[-2]), int(sizes[-1])
        sc_h, sc_w = oh / h, ow / w
    else:
        sc_h, sc_w = float(scales[-2]), float(scales[-1])
        oh, ow = int(np.floor(h * sc_h)), int(np.floor(w * sc_w))

    def src_coord(i, scale, in_len, out_len):
        i = i.astype(np.float64)
        if coord_mode == "asymmetric":
            return i / scale
        if coord_mode in ("pytorch_half_pixel", "half_pixel"):
            xs = (i + 0.5) / scale - 0.5
            if coord_mode == "pytorch_half_pixel" and out_len <= 1:
                return np.zeros_like(xs)
            return xs
        if coord_mode == "align_corners":
            if out_len == 1:
                return np.zeros_like(i)
            return i * (in_len - 1) / (out_len - 1)
        raise UnsupportedOnnxOp(f"Resize coord mode '{coord_mode}'")

    ys = src_coord(np.arange(oh), sc_h, h, oh)
    xs = src_coord(np.arange(ow), sc_w, w, ow)
    if mode == "nearest":
        if nearest_mode == "floor":
            yi, xi = np.floor(ys), np.floor(xs)
        elif nearest_mode == "ceil":
            yi, xi = np.ceil(ys), np.ceil(xs)
        elif nearest_mode == "round_prefer_ceil":
            yi, xi = np.floor(ys + 0.5), np.floor(xs + 0.5)
        else:  # round_prefer_floor (default)
            yi, xi = np.ceil(ys - 0.5), np.ceil(xs - 0.5)
        yi = np.clip(yi, 0, h - 1).astype(np.int64)
        xi = np.clip(xi, 0, w - 1).astype(np.int64)
        return x[:, :, yi][:, :, :, xi]
    if mode == "linear":
        y0 = np.clip(np.floor(ys), 0, h - 1).astype(np.int64)
        y1 = np.clip(y0 + 1, 0, h - 1)
        x0 = np.clip(np.floor(xs), 0, w - 1).astype(np.int64)
        x1 = np.clip(x0 + 1, 0, w - 1)
        wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
        wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
        top = x[:, :, y0][:, :, :, x0] * (1 - wx) + x[:, :, y0][:, :, :, x1] * wx
        bot = x[:, :, y1][:, :, :, x0] * (1 - wx) + x[:, :, y1][:, :, :, x1] * wx
        return top * (1 - wy[:, None]) + bot * wy[:, None]
    raise UnsupportedOnnxOp(f"Resize mode '{mode}'")


def _slice_op(data, starts, ends, axes, steps):
    idx = [slice(None)] * data.ndim
    if axes is None:
        axes = list(range(len(starts)))
    if steps is None:
        steps = [1] * len(starts)
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % data.ndim
        idx[ax] = slice(int(st), int(en), int(sp))
    return data[tuple(idx)]


def _softmax(x, axis):
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x.astype(np.float32)))


def _rnn_directions(node, num_dirs_needed):
    """ONNX RNN direction attr -> list of (slot, reverse_time)."""
    d = _attr(node, "direction", "forward")
    if d == "forward":
        dirs = [(0, False)]
    elif d == "reverse":
        dirs = [(0, True)]
    elif d == "bidirectional":
        dirs = [(0, False), (1, True)]
    else:
        raise UnsupportedOnnxOp(f"RNN direction '{d}'")
    if len(dirs) != num_dirs_needed:
        raise ValueError(
            f"{node.op_type} weights carry {num_dirs_needed} direction(s) "
            f"but direction attr is '{d}'"
        )
    return dirs


def _lstm(node, ins):
    """ONNX ``LSTM`` (torch nn.LSTM exports to this): gate order iofc,
    X [T, N, I] (layout=0), W [D, 4H, I], R [D, 4H, H], B [D, 8H].
    Default activations (sigmoid, tanh, tanh) only."""
    if _attr(node, "activations") is not None:
        raise UnsupportedOnnxOp("LSTM custom activations")
    if int(_attr(node, "layout", 0)) != 0:
        raise UnsupportedOnnxOp("LSTM layout=1")
    x, w, r = (a.astype(np.float32) for a in ins[:3])
    t_len, n, _ = x.shape
    num_dirs, four_h, hid = r.shape[0], r.shape[1], r.shape[2]
    assert four_h == 4 * hid
    b = ins[3].astype(np.float32) if len(ins) > 3 and ins[3] is not None \
        else np.zeros((num_dirs, 8 * hid), np.float32)
    seq_lens = ins[4] if len(ins) > 4 else None
    if seq_lens is not None and not np.all(np.asarray(seq_lens) == t_len):
        raise UnsupportedOnnxOp("LSTM per-sequence lengths")
    h0 = ins[5].astype(np.float32) if len(ins) > 5 and ins[5] is not None \
        else np.zeros((num_dirs, n, hid), np.float32)
    c0 = ins[6].astype(np.float32) if len(ins) > 6 and ins[6] is not None \
        else np.zeros((num_dirs, n, hid), np.float32)
    y = np.zeros((t_len, num_dirs, n, hid), np.float32)
    y_h = np.zeros((num_dirs, n, hid), np.float32)
    y_c = np.zeros((num_dirs, n, hid), np.float32)
    for slot, reverse in _rnn_directions(node, num_dirs):
        wb = b[slot, : 4 * hid] + b[slot, 4 * hid :]
        gates_x = x @ w[slot].T + wb  # [T, N, 4H], iofc
        h, c = h0[slot], c0[slot]
        steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
        for t in steps:
            g = gates_x[t] + h @ r[slot].T
            i = _sigmoid(g[:, :hid])
            o = _sigmoid(g[:, hid : 2 * hid])
            f = _sigmoid(g[:, 2 * hid : 3 * hid])
            ct = np.tanh(g[:, 3 * hid :])
            c = f * c + i * ct
            h = o * np.tanh(c)
            y[t, slot] = h
        y_h[slot], y_c[slot] = h, c
    return y, y_h, y_c


def _gru(node, ins):
    """ONNX ``GRU`` (torch nn.GRU exports with linear_before_reset=1):
    gate order zrh, B [D, 6H]."""
    if _attr(node, "activations") is not None:
        raise UnsupportedOnnxOp("GRU custom activations")
    if int(_attr(node, "layout", 0)) != 0:
        raise UnsupportedOnnxOp("GRU layout=1")
    lbr = int(_attr(node, "linear_before_reset", 0))
    x, w, r = (a.astype(np.float32) for a in ins[:3])
    t_len, n, _ = x.shape
    num_dirs, hid = r.shape[0], r.shape[2]
    b = ins[3].astype(np.float32) if len(ins) > 3 and ins[3] is not None \
        else np.zeros((num_dirs, 6 * hid), np.float32)
    seq_lens = ins[4] if len(ins) > 4 else None
    if seq_lens is not None and not np.all(np.asarray(seq_lens) == t_len):
        raise UnsupportedOnnxOp("GRU per-sequence lengths")
    h0 = ins[5].astype(np.float32) if len(ins) > 5 and ins[5] is not None \
        else np.zeros((num_dirs, n, hid), np.float32)
    y = np.zeros((t_len, num_dirs, n, hid), np.float32)
    y_h = np.zeros((num_dirs, n, hid), np.float32)
    for slot, reverse in _rnn_directions(node, num_dirs):
        wb, rb = b[slot, : 3 * hid], b[slot, 3 * hid :]
        gx = x @ w[slot].T + wb  # [T, N, 3H], zrh
        h = h0[slot]
        steps = range(t_len - 1, -1, -1) if reverse else range(t_len)
        for t in steps:
            gh = h @ r[slot].T  # [N, 3H] (no rb yet — split per gate)
            z = _sigmoid(gx[t][:, :hid] + gh[:, :hid] + rb[:hid])
            rt = _sigmoid(
                gx[t][:, hid : 2 * hid] + gh[:, hid : 2 * hid]
                + rb[hid : 2 * hid]
            )
            if lbr:
                hh = np.tanh(
                    gx[t][:, 2 * hid :]
                    + rt * (gh[:, 2 * hid :] + rb[2 * hid :])
                )
            else:
                hh = np.tanh(
                    gx[t][:, 2 * hid :]
                    + (rt * h) @ r[slot][2 * hid :].T + rb[2 * hid :]
                )
            h = (1.0 - z) * hh + z * h
            y[t, slot] = h
        y_h[slot] = h
    return y, y_h


def run_graph(
    graph_or_path,
    feeds: Dict[str, np.ndarray],
    outputs: Optional[Sequence[str]] = None,
) -> List[np.ndarray]:
    """Evaluate the graph on ``feeds`` ({input name: array}); returns the
    requested ``outputs`` (default: the graph's declared outputs) in order.

    Nodes are evaluated in dependency order (file order when already
    topological — the ONNX requirement; re-scheduled otherwise). Raises
    UnsupportedOnnxOp naming the first op outside the supported set.
    """
    g: OnnxGraph = (
        read_onnx_model(graph_or_path)
        if isinstance(graph_or_path, str) else graph_or_path
    )
    values: Dict[str, np.ndarray] = {"": None}  # "" = absent optional input
    values.update(g.initializers)
    for name, arr in feeds.items():
        values[name] = np.asarray(arr)
    missing = [i for i in g.inputs if i not in values]
    if missing:
        raise ValueError(f"missing graph inputs: {missing}")

    pending: List[OnnxNode] = list(g.nodes)
    while pending:
        progressed = False
        deferred: List[OnnxNode] = []
        for node in pending:
            if any(i and i not in values for i in node.inputs):
                deferred.append(node)
                continue
            _eval_node(node, values)
            progressed = True
        if not progressed:
            blocked = [n.op_type for n in deferred[:5]]
            raise ValueError(
                f"graph is not schedulable (cycle or missing producer); "
                f"blocked at {blocked}"
            )
        pending = deferred

    out_names = list(outputs) if outputs is not None else g.outputs
    missing = [o for o in out_names if o not in values]
    if missing:
        raise ValueError(f"graph did not produce outputs: {missing}")
    return [values[o] for o in out_names]


def _attr(node, name, default=None):
    return node.attrs.get(name, default)


def _eval_node(node: OnnxNode, values: Dict[str, np.ndarray]) -> None:
    op = node.op_type
    ins = [values[i] for i in node.inputs]

    def put(*results):
        for name, r in zip(node.outputs, results):
            if name:  # "" = omitted optional output; never clobber the
                values[name] = r  # values[""]=None absent-input sentinel

    if op == "Constant":
        v = _attr(node, "value")
        if v is None:
            for key, cast in (("value_float", np.float32),
                              ("value_int", np.int64)):
                if _attr(node, key) is not None:
                    v = np.asarray(_attr(node, key), dtype=cast)
                    break
            for key, cast in (("value_floats", np.float32),
                              ("value_ints", np.int64)):
                if _attr(node, key) is not None:
                    v = np.asarray(_attr(node, key), dtype=cast)
                    break
        put(np.asarray(v))
    elif op == "Conv":
        x, w = ins[0], ins[1]
        b = ins[2] if len(ins) > 2 else None
        if x.ndim not in (4, 5):
            raise UnsupportedOnnxOp(f"Conv over {x.ndim - 2}D input")
        if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
            raise UnsupportedOnnxOp("Conv auto_pad")
        k = x.ndim - 2
        put(_convnd(
            x, w, b,
            _attr(node, "strides", [1] * k),
            _attr(node, "pads", [0] * (2 * k)),
            _attr(node, "dilations", [1] * k),
            int(_attr(node, "group", 1)),
        ))
    elif op == "Gemm":
        a, b = ins[0].astype(np.float32), ins[1].astype(np.float32)
        if int(_attr(node, "transA", 0)):
            a = a.T
        if int(_attr(node, "transB", 0)):
            b = b.T
        y = float(_attr(node, "alpha", 1.0)) * (a @ b)
        if len(ins) > 2 and ins[2] is not None:
            y = y + float(_attr(node, "beta", 1.0)) * ins[2]
        put(y)
    elif op == "MatMul":
        put(np.matmul(ins[0].astype(np.float32), ins[1].astype(np.float32)))
    elif op == "BatchNormalization":
        x, scale, bias, mean, var = ins[:5]
        eps = float(_attr(node, "epsilon", 1e-5))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        put((x - mean.reshape(shape))
            / np.sqrt(var.reshape(shape) + eps)
            * scale.reshape(shape) + bias.reshape(shape))
    elif op in ("Relu", "LeakyRelu"):
        alpha = float(_attr(node, "alpha", 0.01)) if op == "LeakyRelu" else 0.0
        put(np.where(ins[0] > 0, ins[0], alpha * ins[0]))
    elif op == "Sigmoid":
        put(1.0 / (1.0 + np.exp(-ins[0].astype(np.float32))))
    elif op == "Tanh":
        put(np.tanh(ins[0].astype(np.float32)))
    elif op == "Softmax":
        put(_softmax(ins[0].astype(np.float32),
                     int(_attr(node, "axis", -1))))
    elif op == "Exp":
        put(np.exp(ins[0].astype(np.float32)))
    elif op == "Sqrt":
        put(np.sqrt(ins[0].astype(np.float32)))
    elif op == "Pow":
        put(np.power(ins[0].astype(np.float32), ins[1]))
    elif op == "Neg":
        put(-ins[0])
    elif op == "Clip":
        lo = ins[1] if len(ins) > 1 and ins[1] is not None else -np.inf
        hi = ins[2] if len(ins) > 2 and ins[2] is not None else np.inf
        lo = _attr(node, "min", lo)
        hi = _attr(node, "max", hi)
        put(np.clip(ins[0], lo, hi))
    elif op in ("Add", "Sub", "Mul", "Div", "Max", "Min"):
        a, b = ins[0], ins[1]
        if op == "Add":
            put(a + b)
        elif op == "Sub":
            put(a - b)
        elif op == "Mul":
            put(a * b)
        elif op == "Div":
            if np.issubdtype(np.asarray(a).dtype, np.integer) and \
                    np.issubdtype(np.asarray(b).dtype, np.integer):
                # ONNX integer Div truncates toward zero; numpy // floors
                a_, b_ = np.asarray(a), np.asarray(b)
                q = a_ // b_
                adj = (a_ % b_ != 0) & ((a_ < 0) != (b_ < 0))
                put(q + adj.astype(q.dtype))
            else:
                put(a / b)
        elif op == "Max":
            put(np.maximum(a, b))
        else:
            put(np.minimum(a, b))
    elif op == "MaxPool":
        kernel = _attr(node, "kernel_shape")
        k = len(kernel)
        if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
            raise UnsupportedOnnxOp("MaxPool auto_pad")
        put(_poolnd(
            ins[0], kernel,
            _attr(node, "strides", [1] * k),
            _attr(node, "pads", [0] * (2 * k)),
            int(_attr(node, "ceil_mode", 0)), "max",
            dilations=_attr(node, "dilations", [1] * k),
        ))
    elif op == "AveragePool":
        kernel = _attr(node, "kernel_shape")
        k = len(kernel)
        if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
            raise UnsupportedOnnxOp("AveragePool auto_pad")
        if any(int(d) != 1 for d in _attr(node, "dilations", [1] * k)):
            raise UnsupportedOnnxOp("AveragePool dilations")
        if int(_attr(node, "count_include_pad", 0)) == 0 and any(
            _attr(node, "pads", [0] * (2 * k))
        ):
            raise UnsupportedOnnxOp("AveragePool count_include_pad=0 w/ pads")
        put(_poolnd(
            ins[0], kernel,
            _attr(node, "strides", [1] * k),
            _attr(node, "pads", [0] * (2 * k)),
            int(_attr(node, "ceil_mode", 0)), "avg",
        ))
    elif op == "GlobalAveragePool":
        put(ins[0].mean(axis=tuple(range(2, ins[0].ndim)), keepdims=True))
    elif op == "Concat":
        put(np.concatenate(ins, axis=int(_attr(node, "axis"))))
    elif op == "Split":
        axis = int(_attr(node, "axis", 0))
        split = _attr(node, "split")
        if split is None and len(ins) > 1 and ins[1] is not None:
            split = [int(s) for s in ins[1]]
        if split is None:
            # ONNX uneven-split rule: ceil-sized chunks, last one smaller
            k = int(_attr(node, "num_outputs", len(node.outputs)))
            length = ins[0].shape[axis]
            base = -(-length // k)
            split = [base] * (k - 1) + [length - base * (k - 1)]
        offs = np.cumsum([0] + list(split))
        put(*[
            np.take(ins[0], range(int(offs[i]), int(offs[i + 1])), axis=axis)
            for i in range(len(split))
        ])
    elif op == "Slice":
        if "starts" in node.attrs:  # opset < 10
            put(_slice_op(ins[0], _attr(node, "starts"),
                          _attr(node, "ends"), _attr(node, "axes"), None))
        else:
            starts, ends = ins[1], ins[2]
            axes = ins[3] if len(ins) > 3 and ins[3] is not None else None
            steps = ins[4] if len(ins) > 4 and ins[4] is not None else None
            put(_slice_op(ins[0], starts, ends, axes, steps))
    elif op == "Reshape":
        shape = [int(s) for s in ins[1]]
        if int(_attr(node, "allowzero", 0)) == 0:
            shape = [
                ins[0].shape[i] if s == 0 else s for i, s in enumerate(shape)
            ]
        put(ins[0].reshape(shape))
    elif op == "Transpose":
        perm = _attr(node, "perm")
        put(np.transpose(ins[0], perm))
    elif op == "Flatten":
        ax = int(_attr(node, "axis", 1))
        put(ins[0].reshape(int(np.prod(ins[0].shape[:ax], initial=1)), -1))
    elif op == "Squeeze":
        axes = _attr(node, "axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = [int(a) for a in ins[1]]
        put(np.squeeze(ins[0], axis=tuple(int(a) for a in axes))
            if axes else np.squeeze(ins[0]))
    elif op == "Unsqueeze":
        axes = _attr(node, "axes")
        if axes is None:
            axes = [int(a) for a in ins[1]]
        out = np.asarray(ins[0])
        out_rank = out.ndim + len(axes)  # axes index the OUTPUT rank
        for a in sorted(int(a) % out_rank for a in axes):
            out = np.expand_dims(out, a)
        put(out)
    elif op == "Expand":
        put(np.broadcast_to(
            ins[0], np.broadcast_shapes(ins[0].shape,
                                        tuple(int(s) for s in ins[1]))
        ).copy())
    elif op == "Tile":
        put(np.tile(ins[0], [int(r) for r in ins[1]]))
    elif op == "Gather":
        put(np.take(ins[0], ins[1].astype(np.int64),
                    axis=int(_attr(node, "axis", 0))))
    elif op == "Shape":
        # opset-15 optional start/end attributes slice the returned shape
        shp = np.asarray(ins[0].shape, dtype=np.int64)
        start, end = _attr(node, "start"), _attr(node, "end")
        if start is not None or end is not None:
            shp = shp[slice(int(start) if start is not None else None,
                            int(end) if end is not None else None)]
        put(shp)
    elif op == "Cast":
        to = int(_attr(node, "to"))
        if to not in _CAST_DTYPES:
            raise UnsupportedOnnxOp(f"Cast to TensorProto dtype code {to}")
        put(ins[0].astype(_CAST_DTYPES[to]))
    elif op == "ConstantOfShape":
        v = _attr(node, "value")
        fill = v.reshape(-1)[0] if v is not None else np.float32(0)
        put(np.full([int(s) for s in ins[0]], fill))
    elif op == "Range":
        put(np.arange(ins[0].item(), ins[1].item(), ins[2].item(),
                      dtype=np.result_type(ins[0], ins[1], ins[2])))
    elif op == "Resize":
        roi = ins[1] if len(ins) > 1 else None  # noqa: F841 — tf_crop only
        scales = ins[2] if len(ins) > 2 and ins[2] is not None and np.size(ins[2]) else None
        sizes = ins[3] if len(ins) > 3 and ins[3] is not None else None
        put(_resize(
            ins[0], scales, sizes,
            _attr(node, "mode", "nearest"),
            _attr(node, "coordinate_transformation_mode", "half_pixel"),
            _attr(node, "nearest_mode", "round_prefer_floor"),
        ))
    elif op in ("ReduceMean", "ReduceSum", "ReduceMax"):
        axes = _attr(node, "axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = [int(a) for a in ins[1]]
        axes = tuple(axes) if axes else None
        keep = bool(int(_attr(node, "keepdims", 1)))
        fn = {"ReduceMean": np.mean, "ReduceSum": np.sum,
              "ReduceMax": np.max}[op]
        put(fn(ins[0], axis=axes, keepdims=keep))
    elif op in ("Identity", "Dropout"):
        put(ins[0])
    elif op == "Where":
        put(np.where(ins[0], ins[1], ins[2]))
    elif op == "Equal":
        put(ins[0] == ins[1])
    elif op == "LSTM":
        if len(ins) > 7 and ins[7] is not None:
            raise UnsupportedOnnxOp("LSTM peepholes")
        put(*_lstm(node, ins))
    elif op == "GRU":
        put(*_gru(node, ins))
    elif op == "Erf":
        # GELU building block; vectorized via math.erf (no scipy in image)
        import math

        put(np.vectorize(math.erf, otypes=[np.float32])(
            ins[0].astype(np.float32)))
    elif op == "ConvTranspose":
        x, w = ins[0], ins[1]
        b = ins[2] if len(ins) > 2 else None
        if x.ndim not in (4, 5):
            raise UnsupportedOnnxOp(f"ConvTranspose over {x.ndim - 2}D input")
        if _attr(node, "auto_pad", "NOTSET") not in ("NOTSET", ""):
            raise UnsupportedOnnxOp("ConvTranspose auto_pad")
        if _attr(node, "output_shape") is not None:
            raise UnsupportedOnnxOp("ConvTranspose output_shape")
        k = x.ndim - 2
        put(_conv_transpose_nd(
            x, w, b,
            [int(s) for s in _attr(node, "strides", [1] * k)],
            [int(p) for p in _attr(node, "pads", [0] * (2 * k))],
            [int(p) for p in _attr(node, "output_padding", [0] * k)],
            [int(d) for d in _attr(node, "dilations", [1] * k)],
            int(_attr(node, "group", 1)),
        ))
    elif op == "InstanceNormalization":
        x, scale, bias = (v.astype(np.float32) for v in ins[:3])
        eps = float(_attr(node, "epsilon", 1e-5))
        sp = tuple(range(2, x.ndim))
        mean = x.mean(axis=sp, keepdims=True)
        var = x.var(axis=sp, keepdims=True)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        put((x - mean) / np.sqrt(var + eps) * scale.reshape(shape)
            + bias.reshape(shape))
    elif op == "GroupNormalization":  # opset 18
        x, scale, bias = (v.astype(np.float32) for v in ins[:3])
        eps = float(_attr(node, "epsilon", 1e-5))
        ng = int(_attr(node, "num_groups"))
        n, c = x.shape[:2]
        xg = x.reshape((n, ng, c // ng) + x.shape[2:])
        red = tuple(range(2, xg.ndim))
        mean = xg.mean(axis=red, keepdims=True)
        var = xg.var(axis=red, keepdims=True)
        y = ((xg - mean) / np.sqrt(var + eps)).reshape(x.shape)
        shape = (1, -1) + (1,) * (x.ndim - 2)
        put(y * scale.reshape(shape) + bias.reshape(shape))
    elif op == "LayerNormalization":  # opset 17
        x = ins[0].astype(np.float32)
        scale = ins[1].astype(np.float32)
        bias = ins[2].astype(np.float32) \
            if len(ins) > 2 and ins[2] is not None else None
        eps = float(_attr(node, "epsilon", 1e-5))
        axis = int(_attr(node, "axis", -1)) % x.ndim
        red = tuple(range(axis, x.ndim))
        mean = x.mean(axis=red, keepdims=True)
        inv = 1.0 / np.sqrt(x.var(axis=red, keepdims=True) + eps)
        y = (x - mean) * inv * scale
        if bias is not None:
            y = y + bias
        put(y, mean, inv)
    elif op == "HardSigmoid":
        alpha = float(_attr(node, "alpha", 0.2))
        beta = float(_attr(node, "beta", 0.5))
        put(np.clip(alpha * ins[0].astype(np.float32) + beta, 0.0, 1.0))
    elif op == "HardSwish":  # opset 14: x * hardsigmoid(x; 1/6, 1/2)
        x = ins[0].astype(np.float32)
        put(x * np.clip(x / 6.0 + 0.5, 0.0, 1.0))
    elif op == "Elu":
        alpha = float(_attr(node, "alpha", 1.0))
        x = ins[0].astype(np.float32)
        put(np.where(x > 0, x, alpha * (np.exp(x) - 1.0)))
    elif op == "Softplus":
        put(np.logaddexp(0.0, ins[0].astype(np.float32)).astype(np.float32))
    elif op == "PRelu":
        x, slope = ins[0], ins[1]
        put(np.where(x < 0, slope * x, x))
    elif op == "Gelu":  # opset 20
        import math

        x = ins[0].astype(np.float32)
        if _attr(node, "approximate", "none") == "tanh":
            put(0.5 * x * (1.0 + np.tanh(
                np.sqrt(2.0 / np.pi) * (x + 0.044715 * x ** 3))))
        else:
            erf = np.vectorize(math.erf, otypes=[np.float32])
            put(0.5 * x * (1.0 + erf(x / np.sqrt(2.0))))
    elif op == "Mish":  # opset 18: x * tanh(softplus(x))
        x = ins[0].astype(np.float32)
        put(x * np.tanh(np.logaddexp(0.0, x)))
    elif op in ("Abs", "Floor", "Ceil", "Round", "Sign", "Not"):
        fn = {"Abs": np.abs, "Floor": np.floor, "Ceil": np.ceil,
              "Round": np.round,  # numpy rounds half-to-even, like ONNX
              "Sign": np.sign, "Not": np.logical_not}[op]
        put(fn(ins[0]))
    elif op in ("Log", "Sin", "Cos", "Reciprocal"):
        x = ins[0].astype(np.float32)
        put({"Log": np.log, "Sin": np.sin, "Cos": np.cos,
             "Reciprocal": lambda v: 1.0 / v}[op](x))
    elif op in ("Greater", "Less", "GreaterOrEqual", "LessOrEqual",
                "And", "Or", "Xor"):
        a, b = ins[0], ins[1]
        put({"Greater": np.greater, "Less": np.less,
             "GreaterOrEqual": np.greater_equal,
             "LessOrEqual": np.less_equal, "And": np.logical_and,
             "Or": np.logical_or, "Xor": np.logical_xor}[op](a, b))
    elif op == "Mod":
        a, b = ins[0], ins[1]
        put(np.fmod(a, b) if int(_attr(node, "fmod", 0)) else np.mod(a, b))
    elif op in ("ReduceMin", "ReduceProd", "ReduceL2"):
        axes = _attr(node, "axes")
        if axes is None and len(ins) > 1 and ins[1] is not None:
            axes = [int(a) for a in ins[1]]
        axes = tuple(axes) if axes else None
        keep = bool(int(_attr(node, "keepdims", 1)))
        if op == "ReduceL2":
            put(np.sqrt(np.sum(
                np.square(ins[0].astype(np.float32)),
                axis=axes, keepdims=keep)))
        else:
            fn = {"ReduceMin": np.min, "ReduceProd": np.prod}[op]
            put(fn(ins[0], axis=axes, keepdims=keep))
    elif op in ("ArgMax", "ArgMin"):
        if int(_attr(node, "select_last_index", 0)):
            raise UnsupportedOnnxOp(f"{op} select_last_index")
        axis = int(_attr(node, "axis", 0))
        keep = bool(int(_attr(node, "keepdims", 1)))
        fn = np.argmax if op == "ArgMax" else np.argmin
        r = fn(ins[0], axis=axis).astype(np.int64)
        put(np.expand_dims(r, axis) if keep else r)
    elif op == "CumSum":
        axis = int(np.asarray(ins[1]).item())
        x = ins[0]
        if int(_attr(node, "reverse", 0)):
            x = np.flip(x, axis)
        r = np.cumsum(x, axis=axis, dtype=x.dtype)
        if int(_attr(node, "exclusive", 0)):
            r = np.concatenate([
                np.zeros_like(np.take(r, [0], axis=axis)),
                _slice_op(r, [0], [x.shape[axis] - 1], [axis], None),
            ], axis=axis)
        if int(_attr(node, "reverse", 0)):
            r = np.flip(r, axis)
        put(r)
    elif op == "Pad":
        mode = _attr(node, "mode", "constant")
        if "pads" in node.attrs:  # opset < 11
            pads = [int(p) for p in _attr(node, "pads")]
            cval = _attr(node, "value", 0.0)
            axes = None
        else:
            pads = [int(p) for p in ins[1]]
            cval = ins[2] if len(ins) > 2 and ins[2] is not None else 0.0
            axes = [int(a) for a in ins[3]] \
                if len(ins) > 3 and ins[3] is not None else None
        x = ins[0]
        if axes is None:
            axes = list(range(x.ndim))
        half = len(pads) // 2
        cfg = [(0, 0)] * x.ndim
        for i, ax in enumerate(axes):
            cfg[ax % x.ndim] = (pads[i], pads[half + i])
        np_mode = {"constant": "constant", "reflect": "reflect",
                   "edge": "edge", "wrap": "wrap"}.get(mode)
        if np_mode is None:
            raise UnsupportedOnnxOp(f"Pad mode '{mode}'")
        if np_mode == "constant":
            put(np.pad(x, cfg, constant_values=np.asarray(cval).item()))
        else:
            put(np.pad(x, cfg, mode=np_mode))
    elif op == "DepthToSpace":
        bs = int(_attr(node, "blocksize"))
        mode = _attr(node, "mode", "DCR")
        n, c, h, w = ins[0].shape
        if mode == "DCR":
            y = ins[0].reshape(n, bs, bs, c // (bs * bs), h, w)
            y = y.transpose(0, 3, 4, 1, 5, 2)
        else:  # CRD (torch PixelShuffle)
            y = ins[0].reshape(n, c // (bs * bs), bs, bs, h, w)
            y = y.transpose(0, 1, 4, 2, 5, 3)
        put(y.reshape(n, c // (bs * bs), h * bs, w * bs))
    elif op == "SpaceToDepth":
        bs = int(_attr(node, "blocksize"))
        n, c, h, w = ins[0].shape
        y = ins[0].reshape(n, c, h // bs, bs, w // bs, bs)
        y = y.transpose(0, 3, 5, 1, 2, 4)
        put(y.reshape(n, c * bs * bs, h // bs, w // bs))
    elif op == "Einsum":
        put(np.einsum(_attr(node, "equation"),
                      *[v.astype(np.float32) for v in ins]))
    elif op == "Trilu":
        k = int(np.asarray(ins[1]).item()) \
            if len(ins) > 1 and ins[1] is not None else 0
        fn = np.triu if int(_attr(node, "upper", 1)) else np.tril
        put(fn(ins[0], k))
    elif op == "TopK":
        x = ins[0]
        k = int(np.asarray(ins[1]).item())
        axis = int(_attr(node, "axis", -1)) % x.ndim
        largest = int(_attr(node, "largest", 1))
        # stable argsort on (-x | x): ties resolve to the lower index,
        # matching ONNX Runtime
        key = -x if largest else x
        idx = np.argsort(key, axis=axis, kind="stable")
        idx = _slice_op(idx, [0], [k], [axis], None)
        put(np.take_along_axis(x, idx, axis=axis), idx.astype(np.int64))
    elif op == "GatherElements":
        put(np.take_along_axis(
            ins[0], ins[1].astype(np.int64),
            axis=int(_attr(node, "axis", 0))))
    elif op == "LogSoftmax":
        x = ins[0].astype(np.float32)
        axis = int(_attr(node, "axis", -1))
        shifted = x - x.max(axis=axis, keepdims=True)
        put(shifted - np.log(
            np.exp(shifted).sum(axis=axis, keepdims=True)))
    elif op == "GlobalMaxPool":
        put(ins[0].max(axis=tuple(range(2, ins[0].ndim)), keepdims=True))
    elif op == "Selu":
        alpha = float(_attr(node, "alpha", 1.6732631921768188))
        gamma = float(_attr(node, "gamma", 1.0507009873554805))
        x = ins[0].astype(np.float32)
        put(gamma * np.where(x > 0, x, alpha * (np.exp(x) - 1.0)))
    elif op == "Celu":
        alpha = float(_attr(node, "alpha", 1.0))
        x = ins[0].astype(np.float32)
        put(np.maximum(x, 0) + np.minimum(
            0, alpha * (np.exp(x / alpha) - 1.0)))
    # ---- quantized-model ops (QDQ + QOperator interchange formats; the
    # pre-quantized-artifact path the reference's RKNN backend consumes,
    # reference detector.py:705-869) --------------------------------------
    elif op == "QuantizeLinear":
        x = np.asarray(ins[0], dtype=np.float32)
        zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
        qdt = np.asarray(zp).dtype if zp is not None else np.dtype(np.uint8)
        scale, zp32 = _qaxis(x.ndim, ins[1], zp, int(_attr(node, "axis", 1)))
        info = np.iinfo(qdt)
        y = np.rint(x / scale) + zp32  # rint = round-half-to-even (spec)
        put(np.clip(y, info.min, info.max).astype(qdt))
    elif op == "DequantizeLinear":
        x = np.asarray(ins[0])
        zp = ins[2] if len(ins) > 2 and ins[2] is not None else None
        scale, zp32 = _qaxis(x.ndim, ins[1], zp, int(_attr(node, "axis", 1)))
        put((x.astype(np.int64) - zp32.astype(np.int64)).astype(
            np.float32) * scale)
    elif op == "DynamicQuantizeLinear":
        x = np.asarray(ins[0], dtype=np.float32)
        # spec: the quantization range always includes 0. All arithmetic
        # in float32 — the jnp twin computes f32, and python-float (f64)
        # scale math here double-rounds into bitwise-different scales
        xmin = np.minimum(x.min(), np.float32(0)) if x.size else np.float32(0)
        xmax = np.maximum(x.max(), np.float32(0)) if x.size else np.float32(0)
        rng_ = np.float32(xmax - xmin)
        # reciprocal multiply, not /255: XLA strength-reduces the constant
        # division to a reciprocal multiply (1 ulp apart), so both
        # executors do the multiply explicitly to stay bit-identical
        scale = np.float32(rng_ * np.float32(1.0 / 255.0)) if rng_ > 0 \
            else np.float32(1.0)
        zp = np.uint8(np.clip(np.rint(np.float32(-xmin) / scale), 0, 255))
        y = np.clip(np.rint(x / scale) + np.float32(zp), 0, 255).astype(
            np.uint8)
        put(y, np.float32(scale), zp)
    elif op == "MatMulInteger":
        azp = ins[2] if len(ins) > 2 and ins[2] is not None else 0
        bzp = ins[3] if len(ins) > 3 and ins[3] is not None else 0
        put(_matmul_int(
            np.asarray(ins[0]), np.asarray(ins[1]), azp, bzp
        ).astype(np.int32))
    elif op == "ConvInteger":
        xzp = ins[2] if len(ins) > 2 else None
        wzp = ins[3] if len(ins) > 3 else None
        put(_conv_int(
            node, np.asarray(ins[0]), np.asarray(ins[1]), xzp, wzp
        ).astype(np.int32))
    elif op == "QLinearConv":
        x, x_s, x_zp, w, w_s, w_zp, y_s, y_zp = ins[:8]
        b = ins[8] if len(ins) > 8 and ins[8] is not None else None
        acc = _conv_int(node, np.asarray(x), np.asarray(w), x_zp, w_zp)
        if b is not None:
            acc = acc + np.asarray(b, dtype=np.int64).reshape(
                (1, -1) + (1,) * (acc.ndim - 2))
        # wrap to int32 like the device accumulator (and like the bare
        # ConvInteger/MatMulInteger outputs) so requant bit-matches the
        # jitted path past 2^31
        acc = acc.astype(np.int32)
        wsc = np.asarray(w_s, dtype=np.float32)  # per-out-channel allowed
        if wsc.ndim == 1 and wsc.size > 1:
            wsc = wsc.reshape((1, -1) + (1,) * (acc.ndim - 2))
        mul = np.float32(_qscalar(x_s, "x_scale")) * wsc \
            / np.float32(_qscalar(y_s, "y_scale"))
        qdt = np.asarray(y_zp).dtype if y_zp is not None \
            else np.dtype(np.uint8)
        put(_requant(acc, mul,
                     int(_qscalar(y_zp, "y_zero_point")) if y_zp is not None
                     else 0, qdt))
    elif op == "QLinearMatMul":
        a, a_s, a_zp, b, b_s, b_zp, y_s, y_zp = ins[:8]
        acc = _matmul_int(np.asarray(a), np.asarray(b),
                          0 if a_zp is None else a_zp,
                          0 if b_zp is None else b_zp
                          ).astype(np.int32)  # wrap like the device
        mul = (np.float32(_qscalar(a_s, "a_scale"))
               * np.float32(_qscalar(b_s, "b_scale"))
               / np.float32(_qscalar(y_s, "y_scale")))
        qdt = np.asarray(y_zp).dtype if y_zp is not None \
            else np.dtype(np.uint8)
        put(_requant(acc, mul,
                     int(_qscalar(y_zp, "y_zero_point")) if y_zp is not None
                     else 0, qdt))
    elif op == "NonMaxSuppression":
        # End-to-end detection exports embed NMS in the graph (the
        # reference's ORT backend executes such files as-is,
        # detector.py:484-609). Semantics follow ONNX Runtime: greedy
        # per-(batch, class) selection in score order, suppress when
        # IoU > iou_threshold, keep only score > score_threshold when one
        # is provided; output rows [batch, class, box] ordered by
        # (batch, class, selection order).
        boxes, scores = np.asarray(ins[0]), np.asarray(ins[1])
        max_out = int(np.asarray(ins[2]).item()) \
            if len(ins) > 2 and ins[2] is not None else 0
        iou_thr = float(np.asarray(ins[3]).item()) \
            if len(ins) > 3 and ins[3] is not None else 0.0
        score_thr = float(np.asarray(ins[4]).item()) \
            if len(ins) > 4 and ins[4] is not None else None
        put(_nms_select(boxes, scores, max_out, iou_thr, score_thr,
                        int(_attr(node, "center_point_box", 0))))
    elif op == "ScatterND":
        data, indices, updates = (np.asarray(v) for v in ins[:3])
        reduction = _attr(node, "reduction", "none") or "none"
        out = data.copy()
        k = indices.shape[-1]
        idx = indices.reshape(-1, k).astype(np.int64)
        upd = updates.reshape(-1, *data.shape[k:])
        for row, u in zip(idx, upd):
            key = tuple(row)
            if reduction == "add":
                out[key] = out[key] + u
            elif reduction == "mul":
                out[key] = out[key] * u
            elif reduction == "min":
                out[key] = np.minimum(out[key], u)
            elif reduction == "max":
                out[key] = np.maximum(out[key], u)
            else:  # "none": later updates win (ONNX processing order)
                out[key] = u
        put(out)
    else:
        raise UnsupportedOnnxOp(
            f"op '{op}' (node '{node.name}') is outside the supported set"
        )


def _nms_corners(boxes: np.ndarray, center_point_box: int) -> np.ndarray:
    """Canonical corners [lo1, lo2, hi1, hi2] per box. center_point_box=1
    is [x_c, y_c, w, h]; 0 is corner pairs supplied in either diagonal
    order (the spec allows flipped corners — normalize with min/max, IoU
    is invariant to the axis naming)."""
    b = boxes.astype(np.float32)
    if center_point_box:
        half = b[..., 2:] * 0.5
        return np.concatenate([b[..., :2] - half, b[..., :2] + half],
                              axis=-1)
    lo = np.minimum(b[..., :2], b[..., 2:])
    hi = np.maximum(b[..., :2], b[..., 2:])
    return np.concatenate([lo, hi], axis=-1)


def _nms_select(boxes, scores, max_out, iou_thr, score_thr,
                center_point_box) -> np.ndarray:
    """Greedy NMS over [B, nb, 4] boxes / [B, C, nb] scores ->
    [num_selected, 3] int64 (batch, class, box) rows."""
    corners = _nms_corners(boxes, center_point_box)
    area = np.prod(np.maximum(corners[..., 2:] - corners[..., :2], 0.0),
                   axis=-1)
    rows = []
    for b in range(scores.shape[0]):
        for c in range(scores.shape[1]):
            sc = scores[b, c].astype(np.float32)
            cand = np.argsort(-sc, kind="stable")
            if score_thr is not None:
                cand = cand[sc[cand] > score_thr]
            picked: List[int] = []
            for i in cand:
                if len(picked) >= max_out:
                    break
                if picked:
                    p = np.asarray(picked)
                    lo = np.maximum(corners[b, i, :2], corners[b, p, :2])
                    hi = np.minimum(corners[b, i, 2:], corners[b, p, 2:])
                    inter = np.prod(np.maximum(hi - lo, 0.0), axis=-1)
                    union = area[b, i] + area[b, p] - inter
                    iou = np.where(union > 0, inter / np.maximum(union, 1e-12),
                                   0.0)
                    if np.any(iou > iou_thr):
                        continue
                picked.append(int(i))
            rows.extend((b, c, i) for i in picked)
    return np.asarray(rows, dtype=np.int64).reshape(-1, 3)
