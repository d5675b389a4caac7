"""Every op of the port's ONNX interpreter (models/onnx_torch.py) against the
JAX package's (models/onnx_jax.py) and the numpy oracle (onnx_exec.run_graph).

Single-node graphs, parametrised, on seeded numpy inputs that go live into
both interpreters (the JAX one run eagerly: every op lowers to jnp exactly as
under ``jax.jit``). Then the op fuzz of tests/test_onnx_fuzz.py (its own
generators), and the bf16 policy against the JAX package's.

Tolerances:
* shape, integer, comparison and index ops: ``array_equal`` (values, not
  integer widths: the port keeps int64 where JAX with x64 off has int32);
* the int32 results of ConvInteger, MatMulInteger and the QLinear ops, and
  the quantized outputs of QuantizeLinear / DynamicQuantizeLinear: bit-equal;
* fp32 float ops: atol 1e-5, rtol 1e-4 (sums in another order than XLA's);
* the bf16 policy against JAX's bf16 policy: outputs within 2 bf16 ulps
  relative (rtol 2 * 2**-8) of JAX's, plus atol 2e-2 for values near zero
  (each side rounds conv, matmul and pointwise outputs to bf16 at its own
  places; the two fp32 references agree to 1e-5).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from realtime_analytics_tpu.models import onnx_jax  # noqa: E402
from realtime_analytics_tpu.models.onnx_exec import run_graph  # noqa: E402
from realtime_analytics_tpu.models.onnx_lite import OnnxGraph, OnnxNode  # noqa: E402
from realtime_analytics_tpu_torch.models import onnx_torch  # noqa: E402
from realtime_analytics_tpu_torch.models.onnx_exec import (  # noqa: E402
    UnsupportedOnnxOp,
)

import test_onnx_fuzz as fuzz  # noqa: E402

F32 = dict(atol=1e-5, rtol=1e-4)


def _graph(op, inputs, outputs=("y",), inits=None, attrs=None, graph_inputs=("x",)):
    return OnnxGraph(nodes=[OnnxNode(op, inputs=list(inputs), outputs=list(outputs),
                                     attrs=dict(attrs or {}))],
                     initializers=dict(inits or {}), inputs=list(graph_inputs),
                     outputs=list(outputs))


def _port(g, feeds, dtype=None):
    fn = onnx_torch.compile_graph(g)
    with onnx_torch.graph_compute_dtype(dtype):
        outs = fn({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in feeds.items()})
    return [o.float().numpy() if isinstance(o, torch.Tensor) and o.dtype == torch.bfloat16
            else np.asarray(o) for o in outs]


def _jax(g, feeds, dtype=None):
    fn = onnx_jax.compile_graph(g)
    with onnx_jax.graph_compute_dtype(dtype):
        outs = fn({k: jnp.asarray(v) for k, v in feeds.items()})
    return [np.asarray(jnp.asarray(o, jnp.float32) if jnp.asarray(o).dtype == jnp.bfloat16
                       else o) for o in outs]


def _hold(g, feeds, exact: bool, oracle=True):
    port, ref = _port(g, feeds), _jax(g, feeds)
    want = run_graph(g, feeds) if oracle else ref
    assert len(port) == len(ref) == len(want)
    for i, (p, j, w) in enumerate(zip(port, ref, want)):
        assert p.shape == j.shape == np.shape(w), (i, p.shape, j.shape, np.shape(w))
        if exact:
            np.testing.assert_array_equal(p, j, err_msg=f"out {i} vs JAX")
            np.testing.assert_array_equal(p, w, err_msg=f"out {i} vs oracle")
        else:
            np.testing.assert_allclose(p, j, **F32, err_msg=f"out {i} vs JAX")
            np.testing.assert_allclose(p, w, **F32, err_msg=f"out {i} vs oracle")
    return port


def _r(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _i8(seed, *shape, dtype=np.int8):
    info = np.iinfo(dtype)
    return np.random.default_rng(seed).integers(info.min, info.max + 1, shape).astype(dtype)


# ---------------------------------------------------------------------------
# float ops: (op, inputs, initializers, attrs, n_outputs)


def _float_cases():
    x4 = _r(1, 2, 4, 9, 11)
    cases = {
        "conv_asym_pads_dil_groups": ("Conv", ["x", "w", "b"],
                                      {"w": _r(2, 6, 2, 3, 3), "b": _r(3, 6)},
                                      {"pads": [1, 0, 2, 1], "dilations": [2, 1],
                                       "strides": [1, 2], "group": 2}, 1),
        "conv_3d": ("Conv", ["x5", "w3"], {"w3": _r(4, 4, 3, 2, 3, 3)},
                    {"pads": [1, 1, 1, 1, 1, 1], "strides": [1, 2, 2]}, 1),
        "conv_transpose_asym": ("ConvTranspose", ["x", "wt", "bt"],
                                {"wt": _r(5, 4, 3, 3, 3), "bt": _r(6, 3)},
                                {"strides": [2, 2], "pads": [1, 0, 0, 1],
                                 "output_padding": [1, 1]}, 1),
        "conv_transpose_groups_dil": ("ConvTranspose", ["x", "wg"], {"wg": _r(7, 4, 2, 2, 3)},
                                      {"strides": [2, 1], "dilations": [1, 2], "group": 2}, 1),
        "maxpool_ceil_pads_dil": ("MaxPool", ["x"], {},
                                  {"kernel_shape": [3, 2], "strides": [2, 2], "pads": [1, 0, 1, 1],
                                   "ceil_mode": 1, "dilations": [1, 2]}, 1),
        "avgpool_ceil_include_pad": ("AveragePool", ["x"], {},
                                     {"kernel_shape": [3, 3], "strides": [2, 2],
                                      "pads": [1, 1, 1, 1], "ceil_mode": 1,
                                      "count_include_pad": 1}, 1),
        "avgpool_3d": ("AveragePool", ["x5"], {}, {"kernel_shape": [2, 2, 2],
                                                   "strides": [1, 2, 2]}, 1),
        "maxpool_1d": ("MaxPool", ["x3"], {}, {"kernel_shape": [3], "strides": [2],
                                               "pads": [1, 1]}, 1),
        "global_avg": ("GlobalAveragePool", ["x"], {}, {}, 1),
        "global_max": ("GlobalMaxPool", ["x"], {}, {}, 1),
        "batchnorm": ("BatchNormalization", ["x", "s", "bb", "m", "v"],
                      {"s": _r(8, 4), "bb": _r(9, 4), "m": _r(10, 4),
                       "v": np.abs(_r(11, 4)) + 0.5}, {"epsilon": 1e-3}, 1),
        "instancenorm": ("InstanceNormalization", ["x", "s", "bb"],
                         {"s": _r(8, 4), "bb": _r(9, 4)}, {}, 1),
        "groupnorm": ("GroupNormalization", ["x", "s", "bb"],
                      {"s": _r(8, 4), "bb": _r(9, 4)}, {"num_groups": 2}, 1),
        "layernorm_3_outputs": ("LayerNormalization", ["x", "ls", "lb"],
                                {"ls": _r(12, 9, 11), "lb": _r(13, 9, 11)}, {"axis": -2}, 3),
        "gemm_trans_alpha_beta": ("Gemm", ["x2", "gw", "gc"],
                                  {"gw": _r(14, 7, 5), "gc": _r(15, 7)},
                                  {"transB": 1, "alpha": 0.5, "beta": 2.0}, 1),
        "gemm_transA": ("Gemm", ["x2t", "gw2"], {"gw2": _r(16, 6, 3)}, {"transA": 1}, 1),
        "matmul_batched": ("MatMul", ["x", "mw"], {"mw": _r(17, 11, 5)}, {}, 1),
        "einsum": ("Einsum", ["x", "ew"], {"ew": _r(18, 4, 11, 3)},
                   {"equation": "nchw,cwk->nhk"}, 1),
        "softmax": ("Softmax", ["x"], {}, {"axis": 1}, 1),
        "logsoftmax": ("LogSoftmax", ["x"], {}, {"axis": -1}, 1),
        "pow": ("Pow", ["x", "p"], {"p": np.array(2.0, np.float32)}, {}, 1),
        "clip_inputs": ("Clip", ["x", "lo", "hi"], {"lo": np.array(-0.5, np.float32),
                                                    "hi": np.array(0.7, np.float32)}, {}, 1),
        "clip_min_only": ("Clip", ["x", "lo"], {"lo": np.array(-0.5, np.float32)}, {}, 1),
        "div_float": ("Div", ["x", "d"], {"d": np.abs(_r(19, 1, 4, 1, 1)) + 0.5}, {}, 1),
        "mod_fmod": ("Mod", ["x", "md"], {"md": np.array(0.7, np.float32)}, {"fmod": 1}, 1),
        "prelu": ("PRelu", ["x", "sl"], {"sl": _r(20, 4, 1, 1)}, {}, 1),
        "reduce_l2": ("ReduceL2", ["x"], {}, {"axes": [1, 3], "keepdims": 0}, 1),
        "reduce_prod": ("ReduceProd", ["x"], {}, {"axes": [2], "keepdims": 1}, 1),
        "reduce_mean_input_axes": ("ReduceMean", ["x", "ax"], {"ax": np.array([-1], np.int64)},
                                   {"keepdims": 0}, 1),
        "reduce_sum_all": ("ReduceSum", ["x"], {}, {"keepdims": 0}, 1),
        "cumsum_exclusive_reverse": ("CumSum", ["x", "ca"], {"ca": np.array(2, np.int64)},
                                     {"exclusive": 1, "reverse": 1}, 1),
        "resize_linear_half_pixel": ("Resize", ["x", "", "sc"],
                                     {"sc": np.array([1, 1, 1.7, 0.6], np.float32)},
                                     {"mode": "linear"}, 1),
        "resize_linear_align_corners": ("Resize", ["x", "", "", "sz"],
                                        {"sz": np.array([2, 4, 13, 5], np.int64)},
                                        {"mode": "linear",
                                         "coordinate_transformation_mode": "align_corners"}, 1),
        "resize_linear_pytorch_half": ("Resize", ["x", "", "", "sz1"],
                                       {"sz1": np.array([2, 4, 1, 7], np.int64)},
                                       {"mode": "linear",
                                        "coordinate_transformation_mode": "pytorch_half_pixel"}, 1),
        "lstm_bidirectional": ("LSTM", ["xs", "lw", "lr", "lbias"],
                               {"lw": _r(21, 2, 20, 6, scale=0.3), "lr": _r(22, 2, 20, 5, scale=0.3),
                                "lbias": _r(23, 2, 40, scale=0.1)},
                               {"hidden_size": 5, "direction": "bidirectional"}, 3),
        "lstm_reverse_init_state": ("LSTM", ["xs", "lw1", "lr1", "lb1", "", "h0", "c0"],
                                    {"lw1": _r(24, 1, 20, 6, scale=0.3),
                                     "lr1": _r(25, 1, 20, 5, scale=0.3),
                                     "lb1": _r(26, 1, 40, scale=0.1), "h0": _r(27, 1, 3, 5),
                                     "c0": _r(28, 1, 3, 5)},
                                    {"hidden_size": 5, "direction": "reverse"}, 3),
        "gru_bidirectional": ("GRU", ["xs", "gw", "gr", "gb"],
                              {"gw": _r(29, 2, 15, 6, scale=0.3), "gr": _r(30, 2, 15, 5, scale=0.3),
                               "gb": _r(31, 2, 30, scale=0.1)},
                              {"hidden_size": 5, "direction": "bidirectional"}, 2),
        "gru_linear_before_reset": ("GRU", ["xs", "gw1", "gr1", "gb1"],
                                    {"gw1": _r(32, 1, 15, 6, scale=0.3),
                                     "gr1": _r(33, 1, 15, 5, scale=0.3),
                                     "gb1": _r(34, 1, 30, scale=0.1)},
                                    {"hidden_size": 5, "linear_before_reset": 1}, 2),
    }
    for op, attrs in (("Relu", {}), ("LeakyRelu", {"alpha": 0.2}), ("Sigmoid", {}),
                      ("Tanh", {}), ("Exp", {}), ("Neg", {}), ("Erf", {}), ("Abs", {}),
                      ("Floor", {}), ("Ceil", {}), ("Round", {}), ("Sign", {}),
                      ("HardSigmoid", {"alpha": 0.3, "beta": 0.4}), ("HardSwish", {}),
                      ("Elu", {"alpha": 0.7}), ("Softplus", {}), ("Gelu", {}),
                      ("Gelu", {"approximate": "tanh"}), ("Mish", {}), ("Sin", {}),
                      ("Cos", {}), ("Selu", {}), ("Celu", {"alpha": 1.3}), ("Identity", {})):
        cases[f"{op}{'_' + '_'.join(attrs) if attrs else ''}"] = (op, ["x"], {}, attrs, 1)
    for op in ("Sqrt", "Log", "Reciprocal"):
        cases[op] = (op, ["xpos"], {}, {}, 1)
    for op in ("Add", "Sub", "Mul", "Max", "Min"):
        cases[f"{op}_broadcast"] = (op, ["x", "bc"], {"bc": _r(35, 4, 1, 11)}, {}, 1)
    feeds = {"x": x4, "x5": _r(40, 2, 3, 5, 8, 8), "x3": _r(41, 2, 3, 10),
             "x2": _r(42, 3, 5), "x2t": _r(43, 6, 4), "xs": _r(44, 4, 3, 6),
             "xpos": np.abs(x4) + 0.1}
    return cases, feeds


_FLOAT_CASES, _FLOAT_FEEDS = _float_cases()


@pytest.mark.parametrize("name", sorted(_FLOAT_CASES))
def test_float_op(name):
    op, ins, inits, attrs, n_out = _FLOAT_CASES[name]
    live = [i for i in ins if i in _FLOAT_FEEDS]
    outs = [f"y{j}" for j in range(n_out)]
    g = _graph(op, ins, outs, inits, attrs, graph_inputs=live)
    _hold(g, {k: _FLOAT_FEEDS[k] for k in live}, exact=False)


# ---------------------------------------------------------------------------
# shape, integer, comparison and index ops: exact


def _exact_cases():
    x = _r(50, 2, 6, 4, 5)
    xi = np.random.default_rng(51).integers(-9, 10, (3, 4)).astype(np.int64)
    ties = np.array([[3.0, 1.0, 3.0, 2.0, 1.0, 3.0]], np.float32)
    idx = np.array([[0, -1, 2], [-3, 1, 0]], np.int64)
    gidx = np.random.default_rng(52).integers(-4, 4, (2, 6, 4, 5)).astype(np.int64)
    c = {
        "reshape_zero_minus_one": ("Reshape", ["x", "t"], {"t": np.array([0, -1, 5], np.int64)}),
        "transpose": ("Transpose", ["x"], {}, {"perm": [0, 3, 1, 2]}),
        "transpose_default": ("Transpose", ["x"], {}),
        "flatten_axis2": ("Flatten", ["x"], {}, {"axis": 2}),
        "flatten_axis0": ("Flatten", ["x"], {}, {"axis": 0}),
        "squeeze_input_axes": ("Squeeze", ["x1", "sa"], {"sa": np.array([1, -2], np.int64)}),
        "squeeze_all": ("Squeeze", ["x1"], {}),
        "unsqueeze_neg": ("Unsqueeze", ["x", "ua"], {"ua": np.array([-1, 0], np.int64)}),
        "unsqueeze_attr": ("Unsqueeze", ["x"], {}, {"axes": [2]}),
        "expand": ("Expand", ["x1", "es"], {"es": np.array([2, 3, 4, 1, 5], np.int64)}),
        "tile": ("Tile", ["x", "rp"], {"rp": np.array([1, 2, 1, 3], np.int64)}),
        "slice_neg_steps": ("Slice", ["x", "st", "en", "ax", "sp"],
                            {"st": np.array([-1, 4], np.int64), "en": np.array([-100, 0], np.int64),
                             "ax": np.array([1, 3], np.int64), "sp": np.array([-2, -1], np.int64)}),
        "slice_big_end": ("Slice", ["x", "st1", "en1"],
                          {"st1": np.array([1], np.int64),
                           "en1": np.array([np.iinfo(np.int64).max], np.int64)}),
        "slice_opset9": ("Slice", ["x"], {}, {"starts": [0, 1], "ends": [1, 3], "axes": [0, 2]}),
        "split_uneven_num_outputs": ("Split", ["x"], {}, {"axis": 1, "num_outputs": 4}, 4),
        "split_sizes": ("Split", ["x", "ss"], {"ss": np.array([1, 2, 2], np.int64)},
                        {"axis": 3}, 3),
        "concat_with_constant": ("Concat", ["x", "cc"], {"cc": _r(53, 2, 1, 4, 5)}, {"axis": 1}),
        "gather_static_negative": ("Gather", ["x", "gi"], {"gi": idx}, {"axis": 1}),
        "gather_scalar_index": ("Gather", ["x", "g0"], {"g0": np.array(-1, np.int64)},
                                {"axis": 3}),
        "gather_live_index": ("Gather", ["tab", "li"], {"tab": _r(54, 7, 3)}, {"axis": 0}),
        "gather_elements": ("GatherElements", ["x", "ge"], {"ge": gidx}, {"axis": 2}),
        "pad_constant": ("Pad", ["x", "pp", "pv"], {"pp": np.array([0, 1, 2, 0, 0, 2, 0, 1],
                                                                  np.int64),
                                                    "pv": np.array(0.5, np.float32)}),
        "pad_reflect": ("Pad", ["x", "pq"], {"pq": np.array([0, 0, 2, 1, 0, 0, 1, 3], np.int64)},
                        {"mode": "reflect"}),
        "pad_edge_axes": ("Pad", ["x", "pr", "", "pa"],
                          {"pr": np.array([2, 1, 1, 2], np.int64),
                           "pa": np.array([1, -1], np.int64)}, {"mode": "edge"}),
        "pad_wrap": ("Pad", ["x", "pq"], {"pq": np.array([0, 0, 2, 1, 0, 0, 1, 3], np.int64)},
                     {"mode": "wrap"}),
        "depth_to_space_dcr": ("DepthToSpace", ["x4c"], {}, {"blocksize": 2}),
        "depth_to_space_crd": ("DepthToSpace", ["x4c"], {}, {"blocksize": 2, "mode": "CRD"}),
        "space_to_depth": ("SpaceToDepth", ["x4s"], {}, {"blocksize": 2}),
        "trilu_upper": ("Trilu", ["x", "tk"], {"tk": np.array(1, np.int64)}),
        "trilu_lower": ("Trilu", ["x"], {}, {"upper": 0}),
        "cumsum_int": ("CumSum", ["xi", "c1"], {"c1": np.array(1, np.int64)}),
        "topk_largest_ties": ("TopK", ["tie", "k3"], {"k3": np.array([3], np.int64)}, {},
                              2),
        "topk_smallest_ties": ("TopK", ["tie", "k3"], {"k3": np.array([4], np.int64)},
                               {"largest": 0}, 2),
        "argmax_ties": ("ArgMax", ["tie"], {}, {"axis": 1}),
        "argmin_nokeep": ("ArgMin", ["x"], {}, {"axis": 2, "keepdims": 0}),
        "reduce_max": ("ReduceMax", ["x"], {}, {"axes": [1, 2]}),
        "reduce_min_nokeep": ("ReduceMin", ["x"], {}, {"axes": [0], "keepdims": 0}),
        "div_int_truncates": ("Div", ["xi", "dv"], {"dv": np.array([[4, -3, 2, -5]], np.int64)},
                              {}),
        "mod_int": ("Mod", ["xi", "dv"], {"dv": np.array([[4, -3, 2, -5]], np.int64)},
                    {}),
        "resize_nearest_floor_asym": ("Resize", ["x", "", "sc"],
                                      {"sc": np.array([1, 1, 2, 2], np.float32)},
                                      {"coordinate_transformation_mode": "asymmetric",
                                       "nearest_mode": "floor"}),
        "resize_nearest_round_half": ("Resize", ["x", "", "sc2"],
                                      {"sc2": np.array([1, 1, 1.5, 0.7], np.float32)}, {}),
        "resize_nearest_ceil_sizes": ("Resize", ["x", "", "", "nsz"],
                                      {"nsz": np.array([2, 6, 7, 9], np.int64)},
                                      {"nearest_mode": "ceil",
                                       "coordinate_transformation_mode": "align_corners"}),
        "resize_nearest_round_prefer_ceil": ("Resize", ["x", "", "sc2"],
                                             {"sc2": np.array([1, 1, 1.5, 0.7], np.float32)},
                                             {"nearest_mode": "round_prefer_ceil"}),
        "where": ("Where", ["cond", "x", "wy"], {"cond": _r(55, 1, 6, 4, 1) > 0,
                                                 "wy": np.array(-2.0, np.float32)}),
        "equal_int": ("Equal", ["xi", "eq"], {"eq": np.array([[1, 2, -3, 0]], np.int64)},
                      {}),
        "not_bool": ("Not", ["xb"], {}),
    }
    for op in ("Greater", "Less", "GreaterOrEqual", "LessOrEqual"):
        c[op] = (op, ["x", "cmp"], {"cmp": _r(56, 6, 1, 5)})
    for op in ("And", "Or", "Xor"):
        c[op] = (op, ["xb", "bb"], {"bb": np.array([[True, False, True, False]])})
    for to in (1, 3, 5, 6, 7, 9, 11):
        c[f"cast_to_{to}"] = ("Cast", ["xc"], {}, {"to": to})
    c["cast_to_2"] = ("Cast", ["xu"], {}, {"to": 2})  # uint8: in range only
    feeds = {"x": x, "x1": _r(57, 2, 1, 4, 1, 5), "xi": xi, "tie": ties,
             "li": np.array([[6, -1], [0, 3]], np.int64), "x4c": _r(58, 2, 8, 3, 4), "x4s": _r(61, 2, 3, 4, 6),
             "xb": xi > 0, "xc": (_r(59, 3, 7) * 40).round(1),
             "xu": np.abs(_r(60, 3, 7) * 80).round(1)}
    return c, feeds


_EXACT_CASES, _EXACT_FEEDS = _exact_cases()


@pytest.mark.parametrize("name", sorted(_EXACT_CASES))
def test_exact_op(name):
    op, ins, inits, attrs, n_out = _EXACT_CASES[name] + ({}, 1)[len(_EXACT_CASES[name]) - 3:]
    live = [i for i in ins if i in _EXACT_FEEDS]
    g = _graph(op, ins, [f"y{j}" for j in range(n_out)], inits, attrs, graph_inputs=live)
    _hold(g, {k: _EXACT_FEEDS[k] for k in live}, exact=True)


def test_shape_of_live_tensor_folds_with_start_end():
    """``Shape`` of a live tensor is numpy (it folds); opset-15 start/end."""
    g = OnnxGraph(nodes=[
        OnnxNode("Shape", ["x"], ["s"], attrs={"start": 1, "end": -1}),
        OnnxNode("Concat", ["neg", "s"], ["t"], attrs={"axis": 0}),
        OnnxNode("Reshape", ["x", "t"], ["y"]),
    ], initializers={"neg": np.array([-1], np.int64)}, inputs=["x"], outputs=["y", "s"])
    port = _hold(g, {"x": _EXACT_FEEDS["x"]}, exact=True)
    np.testing.assert_array_equal(port[1], [6, 4])


# ---------------------------------------------------------------------------
# quantized ops: bit-equal


def _quant_cases():
    x = _r(60, 2, 4, 7, 6, scale=2.0)
    a_u8 = _i8(61, 2, 5, 12, dtype=np.uint8)
    b_s8 = _i8(62, 12, 6)
    xq = _i8(63, 2, 4, 7, 6, dtype=np.uint8)
    wq = _i8(64, 6, 2, 3, 3)
    return {
        "quantize_per_axis_int8": ("QuantizeLinear", ["x", "qs", "qz"],
                                   {"qs": np.array([0.02, 0.05, 0.1, 0.03], np.float32),
                                    "qz": np.array([0, 3, -2, 1], np.int8)}, {"axis": 1}, ["x"]),
        "quantize_default_uint8": ("QuantizeLinear", ["x", "s0"],
                                   {"s0": np.array(0.013, np.float32)}, {}, ["x"]),
        "dequantize_per_axis": ("DequantizeLinear", ["xq", "ds", "dz"],
                                {"ds": np.array([0.1, 0.2, 0.3, 0.4], np.float32),
                                 "dz": np.array([128, 120, 130, 0], np.uint8)}, {"axis": 1},
                                ["xq"]),
        "dequantize_int32_bias": ("DequantizeLinear", ["bi", "bs"],
                                  {"bs": np.array(0.25, np.float32)}, {}, ["bi"]),
        "dynamic_quantize": ("DynamicQuantizeLinear", ["x"], {}, {}, ["x"], 3),
        "matmul_integer_zero_points": ("MatMulInteger", ["a", "b", "az", "bz"],
                                       {"b": b_s8, "az": np.array(131, np.uint8),
                                        "bz": np.array([1, -2, 0, 3, -1, 5], np.int8)}, {},
                                       ["a"]),
        "matmul_integer_symmetric": ("MatMulInteger", ["as8", "b"], {"b": b_s8}, {}, ["as8"]),
        "matmul_integer_1d": ("MatMulInteger", ["a1", "b"], {"b": b_s8}, {}, ["a1"]),
        "conv_integer_zp_pads_groups": ("ConvInteger", ["xq", "wq", "xz", "wz"],
                                        {"wq": wq, "xz": np.array(117, np.uint8),
                                         "wz": np.array(3, np.int8)},
                                        {"pads": [1, 2, 0, 1], "strides": [2, 1], "group": 2},
                                        ["xq"]),
        "conv_integer_depthwise_dilated": ("ConvInteger", ["xq", "wd"],
                                           {"wd": _i8(65, 4, 1, 3, 3)},
                                           {"group": 4, "dilations": [2, 1], "pads": [2, 1, 2, 1]},
                                           ["xq"]),
        "qlinear_conv_per_channel_bias": ("QLinearConv",
                                          ["xq", "xs", "xz", "wq2", "ws", "wz2", "ys", "yz", "qb"],
                                          {"xs": np.array(0.05, np.float32),
                                           "xz": np.array(117, np.uint8),
                                           "wq2": _i8(66, 5, 4, 3, 3),
                                           "ws": np.array([0.01, 0.02, 0.015, 0.03, 0.005],
                                                          np.float32),
                                           "wz2": np.zeros(5, np.int8),
                                           "ys": np.array(0.3, np.float32),
                                           "yz": np.array(128, np.uint8),
                                           "qb": np.random.default_rng(67).integers(
                                               -500, 500, 5).astype(np.int32)},
                                          {"pads": [1, 1, 1, 1]}, ["xq"]),
        "qlinear_matmul": ("QLinearMatMul", ["a", "as_", "az", "b", "bs_", "bz0", "ys", "yz8"],
                           {"as_": np.array(0.02, np.float32), "az": np.array(131, np.uint8),
                            "b": b_s8, "bs_": np.array(0.01, np.float32),
                            "bz0": np.array(0, np.int8), "ys": np.array(0.5, np.float32),
                            "yz8": np.array(-3, np.int8)}, {}, ["a"]),
    }, {"x": x, "xq": xq, "a": a_u8, "as8": _i8(68, 3, 5, 12), "a1": _i8(69, 12),
        "bi": np.random.default_rng(70).integers(-2**20, 2**20, (3, 4)).astype(np.int32)}


_QUANT_CASES, _QUANT_FEEDS = _quant_cases()


@pytest.mark.parametrize("name", sorted(_QUANT_CASES))
def test_quantized_op_bit_equal(name):
    spec = _QUANT_CASES[name]
    op, ins, inits, attrs, live = spec[:5]
    n_out = spec[5] if len(spec) > 5 else 1
    g = _graph(op, ins, [f"y{j}" for j in range(n_out)], inits, attrs, graph_inputs=live)
    feeds = {k: _QUANT_FEEDS[k] for k in live}
    port, ref, want = _port(g, feeds), _jax(g, feeds), run_graph(g, feeds)
    for p, j, w in zip(port, ref, want):
        assert p.dtype == np.asarray(w).dtype or p.dtype.kind == np.asarray(w).dtype.kind
        np.testing.assert_array_equal(p, j)
        np.testing.assert_array_equal(p, w)


def test_conv_integer_int32_sums_exact_past_fp32_mantissa():
    """int32 accumulators past 2**24 are exact (an fp32 conv would round)."""
    x = np.full((1, 64, 5, 5), 255, np.uint8)
    w = np.full((2, 64, 3, 3), -128, np.int8)
    g = _graph("ConvInteger", ["x", "w"], inits={"w": w})
    (p,) = _port(g, {"x": x})
    (want,) = run_graph(g, {"x": x})
    assert np.abs(want).max() > 2 ** 24
    np.testing.assert_array_equal(p, want)


# ---------------------------------------------------------------------------
# refusals, the padded NMS contract


def test_unsupported_ops_raise_as_jax():
    from realtime_analytics_tpu.models.onnx_exec import UnsupportedOnnxOp as JaxUnsupported

    g = _graph("NonZero", ["x"])
    for compile_graph, feed, exc in (
            (onnx_torch.compile_graph, torch.zeros(2, 2), UnsupportedOnnxOp),
            (onnx_jax.compile_graph, jnp.zeros((2, 2)), JaxUnsupported)):
        with pytest.raises(exc, match="outside the supported set"):
            compile_graph(g)({"x": feed})
    bad = _graph("Reshape", ["x", "s"], graph_inputs=("x", "s"))
    with pytest.raises(UnsupportedOnnxOp, match="data-dependent"):
        onnx_torch.compile_graph(bad)({"x": torch.zeros(2, 2),
                                       "s": torch.tensor([4], dtype=torch.int64)})
    pool = _graph("AveragePool", ["x"], attrs={"kernel_shape": [2, 2], "pads": [1, 1, 1, 1]})
    with pytest.raises(UnsupportedOnnxOp, match="count_include_pad"):
        onnx_torch.compile_graph(pool)({"x": torch.zeros(1, 1, 4, 4)})


def _drop_pad(rows):
    rows = np.asarray(rows)
    return rows[rows[:, 0] >= 0]


@pytest.mark.parametrize("seed", range(5))
def test_nms_padded_contract(seed):
    """The port's padded rows equal JAX's padded rows; dropping pads gives
    the oracle's dense rows in order (tests/test_onnx_fuzz.py's draw)."""
    rng = np.random.default_rng(1000 + seed)
    B, nb, C = int(rng.integers(1, 3)), int(rng.integers(4, 24)), int(rng.integers(1, 4))
    center = int(rng.integers(2))
    if center:
        boxes = np.concatenate([rng.uniform(0, 10, (B, nb, 2)),
                                rng.uniform(-1.5, 6, (B, nb, 2))], axis=-1).astype(np.float32)
    else:
        boxes = rng.uniform(0, 10, (B, nb, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (B, C, nb)).astype(np.float32)
    scores[:, :, : nb // 3] = scores[:, :, :1]  # ties: the lower index first
    inits = {"mo": np.array([int(rng.integers(1, nb + 2))], np.int64),
             "it": np.array([float(rng.uniform(0.2, 0.8))], np.float32)}
    ins = ["boxes", "scores", "mo", "it"]
    if rng.integers(2):
        inits["st"] = np.array([float(rng.uniform(0.1, 0.5))], np.float32)
        ins.append("st")
    g = _graph("NonMaxSuppression", ins, ["sel"], inits, {"center_point_box": center},
               graph_inputs=("boxes", "scores"))
    feeds = {"boxes": boxes, "scores": scores}
    (p,), (j,), (w,) = _port(g, feeds), _jax(g, feeds), run_graph(g, feeds)
    assert p.shape[0] == B * C * min(int(inits["mo"][0]), nb)
    np.testing.assert_array_equal(p, j)
    np.testing.assert_array_equal(_drop_pad(p), w)


# ---------------------------------------------------------------------------
# the op fuzz of tests/test_onnx_fuzz.py, the port as a third executor


@pytest.mark.parametrize("seed", range(0, 40, 2))
def test_fuzz_chains(seed):
    g, feed = fuzz._build_case(seed)
    with np.errstate(all="ignore"):
        (want,) = run_graph(g, feed)
    if not np.all(np.isfinite(want)):
        pytest.skip("degenerate numerics for this seed")
    (p,), (j,) = _port(g, feed), _jax(g, feed)
    ctx = f"seed {seed}: {[n.op_type for n in g.nodes]}"
    np.testing.assert_allclose(p, j, atol=1e-4, rtol=1e-3, err_msg=ctx)
    np.testing.assert_allclose(p, want, atol=1e-4, rtol=1e-3, err_msg=ctx)


@pytest.mark.parametrize("seed", range(100, 125, 4))
def test_fuzz_heavy_stacks(seed):
    rng = np.random.default_rng(seed)
    shape = (int(rng.integers(1, 3)), int(rng.integers(1, 3)) * 2,
             int(rng.integers(6, 13)), int(rng.integers(6, 13)))
    x = rng.standard_normal(shape).astype(np.float32)
    nodes, inits, cur, made = [], {}, shape, 0
    for i in range(4):
        got = fuzz._heavy_layer(rng, cur, i)
        if got is None:
            continue
        node, extras, cur = got
        node.inputs[0] = "x" if made == 0 else f"out{made - 1}"
        node.outputs[0] = f"out{made}"
        nodes.append(node)
        inits.update(extras)
        made += 1
    if made == 0:
        pytest.skip("no valid layer drawn for this seed")
    nodes.append(OnnxNode("Tanh", inputs=[f"out{made - 1}"], outputs=["y"]))
    g = OnnxGraph(nodes=nodes, initializers=inits, inputs=["x"], outputs=["y"])
    (p,), (j,), (w,) = _port(g, {"x": x}), _jax(g, {"x": x}), run_graph(g, {"x": x})
    ctx = f"seed {seed}: {[n.op_type for n in g.nodes]}"
    np.testing.assert_allclose(p, j, atol=2e-4, rtol=1e-3, err_msg=ctx)
    np.testing.assert_allclose(p, w, atol=2e-4, rtol=1e-3, err_msg=ctx)


@pytest.mark.parametrize("seed", range(200, 208, 2))
def test_fuzz_quantized_graphs(seed):
    """Random conv nets quantized by the JAX package's quantiser (QDQ or
    QOperator): the port equals the JAX interpreter within one quantum of
    the widest activation scale (a float conv inside a QDQ graph can round
    a Q node across a boundary), as the JAX fuzz holds JAX to the oracle."""
    from realtime_analytics_tpu.models.quantize import quantize_graph

    rng = np.random.default_rng(seed)
    g, x = fuzz._random_convnet(rng)
    fmt = "qoperator" if rng.integers(2) else "qdq"
    feeds = [{"x": rng.standard_normal(x.shape).astype(np.float32)} for _ in range(3)]
    qg, _ = quantize_graph(g, feeds + [{"x": x}], fmt=fmt)
    (p,), (j,) = _port(qg, {"x": x}), _jax(qg, {"x": x})
    scales = [float(np.asarray(v).reshape(-1).max()) for k, v in qg.initializers.items()
              if k.endswith("_scale") and np.asarray(v).dtype == np.float32]
    quantum = max(scales) if scales else 1e-3
    np.testing.assert_allclose(p, j, atol=max(2 * quantum, 1e-4), rtol=1e-3,
                               err_msg=f"seed {seed} {fmt}")


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_scatternd(seed):
    rng = np.random.default_rng(2000 + seed)
    r = int(rng.integers(1, 4))
    shape = tuple(int(rng.integers(2, 6)) for _ in range(r))
    k = int(rng.integers(1, r + 1))
    reduction = ["none", "add", "mul", "min", "max"][seed % 5]
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape[:k]], indexing="ij"),
                    axis=-1).reshape(-1, k)
    n_upd = int(rng.integers(1, min(6, len(grid)) + 1))
    indices = grid[rng.choice(len(grid), size=n_upd, replace=False)].astype(np.int64)
    data = rng.standard_normal(shape).astype(np.float32)
    updates = rng.standard_normal((n_upd, *shape[k:])).astype(np.float32)
    g = _graph("ScatterND", ["data", "idx", "upd"], inits={"idx": indices, "upd": updates},
               attrs={} if reduction == "none" else {"reduction": reduction},
               graph_inputs=("data",))
    _hold(g, {"data": data}, exact=False)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_constantofshape_range(seed):
    rng = np.random.default_rng(3000 + seed)
    n, m = int(rng.integers(2, 5)), int(rng.integers(2, 6))
    start, delta = int(rng.integers(-3, 3)), int(rng.integers(1, 3))
    g = OnnxGraph(nodes=[
        OnnxNode("Range", ["rs", "rl", "rd"], ["r"]),
        OnnxNode("Cast", ["r"], ["rf"], attrs={"to": 1}),
        OnnxNode("ConstantOfShape", ["shp"], ["cs"],
                 attrs={"value": np.array([float(rng.uniform(-2, 2))], np.float32)}),
        OnnxNode("Add", ["x", "rf"], ["xr"]),
        OnnxNode("Mul", ["xr", "cs"], ["y"]),
    ], initializers={"rs": np.array(start, np.int64), "rl": np.array(start + delta * m, np.int64),
                     "rd": np.array(delta, np.int64), "shp": np.array([n, m], np.int64)},
        inputs=["x"], outputs=["y"])
    _hold(g, {"x": rng.standard_normal((n, m)).astype(np.float32)}, exact=False)


# ---------------------------------------------------------------------------
# the bf16 policy


BF16 = dict(atol=2e-2, rtol=2 * 2 ** -8)


@pytest.mark.parametrize("name", ["conv_asym_pads_dil_groups", "conv_transpose_asym",
                                  "gemm_trans_alpha_beta", "matmul_batched", "einsum",
                                  "Sigmoid", "Gelu", "HardSwish", "maxpool_ceil_pads_dil",
                                  "avgpool_ceil_include_pad", "softmax", "layernorm_3_outputs",
                                  "batchnorm", "reduce_mean_input_axes", "pow",
                                  "lstm_bidirectional", "gru_bidirectional"])
def test_bf16_policy_against_jax(name):
    """Under the bf16 policy every live float output is bf16 on both sides;
    fp32 islands (norms, softmax, reductions, avg pools, scans, Pow) compute
    in fp32 first. The port's outputs are within the module's bf16 bound of
    JAX's."""
    op, ins, inits, attrs, n_out = _FLOAT_CASES[name]
    live = [i for i in ins if i in _FLOAT_FEEDS]
    g = _graph(op, ins, [f"y{j}" for j in range(n_out)], inits, attrs, graph_inputs=live)
    feeds = {k: _FLOAT_FEEDS[k] for k in live}
    fn = onnx_torch.compile_graph(g)
    with onnx_torch.graph_compute_dtype(torch.bfloat16):
        raw = fn({k: torch.from_numpy(v) for k, v in feeds.items()})
    assert all(o.dtype == torch.bfloat16 for o in raw)
    port = [o.float().numpy() for o in raw]
    ref = _jax(g, feeds, jnp.bfloat16)
    for p, j in zip(port, ref):
        np.testing.assert_allclose(p, j, **BF16)
