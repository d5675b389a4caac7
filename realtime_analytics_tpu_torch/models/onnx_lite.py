"""Minimal ONNX reader: initializers AND the node graph, no onnx package.

The reference's primary model interchange format is ONNX (its ONNX Runtime /
OpenVINO backends and the temporal exporter all speak it,
reference detector.py:484-609). This image ships no ``onnx`` package, but an
ONNX file is plain protobuf — this module hand-decodes the subset the
framework needs:

* ``read_onnx_initializers`` — just the weights (checkpoint loading; names
  in torch-exported models preserve the state-dict naming).
* ``read_onnx_model`` — the full executable graph (nodes with attributes,
  initializers, graph inputs/outputs), evaluated by
  ``models.onnx_exec.run_graph``. This is the fidelity oracle's input: a
  torch-exported ONNX graph carries torch's own operational semantics of
  the architecture, independent of this repo's model code.

Wire-format fields decoded:

    ModelProto.graph(7) -> GraphProto: node(1), initializer(5),
        input(11), output(12)
    NodeProto: input(1), output(2), name(3), op_type(4), attribute(5)
    AttributeProto: name(1), f(2), i(3), s(4), t(5), floats(7), ints(8),
        strings(9)
    TensorProto: dims(1), data_type(2), float_data(4), int64_data(7),
        name(8), raw_data(9)
    ValueInfoProto: name(1) (shapes skipped — execution infers them)

Anything else (doc strings, opsets, value_info) is skipped by generic
field skipping.

The port's copy of ``realtime_analytics_tpu/models/onnx_lite.py`` (numpy
only): the PyTorch package imports nothing of the JAX package.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

# ONNX TensorProto.DataType -> numpy
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _to_signed64(v: int) -> int:
    """Protobuf encodes int64 as 64-bit two's complement varints; fold the
    unsigned decode back to signed so e.g. -1 doesn't arrive as 2**64-1."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _read_field_header(buf: bytes, pos: int) -> Tuple[int, int, int]:
    key, pos = _read_varint(buf, pos)
    return key >> 3, key & 0x7, pos


def _skip_field(buf: bytes, pos: int, wire_type: int) -> int:
    if wire_type == 0:  # varint
        _, pos = _read_varint(buf, pos)
        return pos
    if wire_type == 1:  # fixed64
        return pos + 8
    if wire_type == 2:  # length-delimited
        n, pos = _read_varint(buf, pos)
        return pos + n
    if wire_type == 5:  # fixed32
        return pos + 4
    raise ValueError(f"unsupported protobuf wire type {wire_type}")


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    pos = 0
    dims: List[int] = []
    dtype_code = 1
    name = ""
    raw = b""
    float_data: List[float] = []
    int64_data: List[int] = []
    n = len(buf)
    while pos < n:
        field, wt, pos = _read_field_header(buf, pos)
        if field == 1 and wt == 0:  # dims (unpacked)
            v, pos = _read_varint(buf, pos)
            dims.append(_to_signed64(v))
        elif field == 1 and wt == 2:  # dims (packed)
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(buf, pos)
                dims.append(_to_signed64(v))
        elif field == 2 and wt == 0:  # data_type
            dtype_code, pos = _read_varint(buf, pos)
        elif field == 4 and wt == 2:  # float_data (packed)
            ln, pos = _read_varint(buf, pos)
            float_data.extend(
                struct.unpack(f"<{ln // 4}f", buf[pos : pos + ln])
            )
            pos += ln
        elif field == 4 and wt == 5:  # float_data (unpacked)
            float_data.append(struct.unpack("<f", buf[pos : pos + 4])[0])
            pos += 4
        elif field == 7 and wt == 2:  # int64_data (packed)
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(buf, pos)
                int64_data.append(_to_signed64(v))
        elif field == 7 and wt == 0:  # int64_data (unpacked)
            v, pos = _read_varint(buf, pos)
            int64_data.append(_to_signed64(v))
        elif field == 8 and wt == 2:  # name
            ln, pos = _read_varint(buf, pos)
            name = buf[pos : pos + ln].decode("utf-8")
            pos += ln
        elif field == 9 and wt == 2:  # raw_data
            ln, pos = _read_varint(buf, pos)
            raw = buf[pos : pos + ln]
            pos += ln
        else:
            pos = _skip_field(buf, pos, wt)
    np_dtype = _DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"tensor '{name}': unsupported ONNX dtype {dtype_code}")
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=np.float32)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np.int64)
    else:
        arr = np.zeros(0, dtype=np_dtype)
    if dims:
        return name, arr.reshape(dims)
    if arr.size == 1:
        # dims=[] is a SCALAR tensor (rank 0) — returning shape (1,) would
        # e.g. make Gather(scalar index) keep the gathered axis
        return name, arr.reshape(())
    return name, arr


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _len_delimited(field: int, payload: bytes) -> bytes:
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


_NP_TO_ONNX = {np.dtype(np.float32): 1, np.dtype(np.float16): 10,
               np.dtype(np.int64): 7, np.dtype(np.int32): 6,
               np.dtype(np.int8): 3, np.dtype(np.uint8): 2,
               np.dtype(np.uint16): 4, np.dtype(np.int16): 5,
               np.dtype(np.bool_): 9, np.dtype(np.float64): 11,
               np.dtype(np.uint32): 12, np.dtype(np.uint64): 13}


def write_onnx_initializers(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """Serialize {name: array} as a minimal .onnx file (initializers only —
    a weights container, not an executable graph). Round-trips through
    ``read_onnx_initializers`` and standard ONNX tooling can read the
    initializers too."""
    inits = b""
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        dt = _NP_TO_ONNX.get(arr.dtype)
        if dt is None:
            arr = arr.astype(np.float32)
            dt = 1
        t = b""
        for d in arr.shape:
            t += _varint(1 << 3) + _varint(d)  # dims, field 1 varint
        t += _varint(2 << 3) + _varint(dt)  # data_type, field 2
        t += _len_delimited(8, name.encode("utf-8"))  # name
        t += _len_delimited(9, arr.tobytes())  # raw_data
        inits += _len_delimited(5, t)  # GraphProto.initializer
    graph = _len_delimited(2, b"weights") + inits  # name + initializers
    model = (
        _varint(1 << 3) + _varint(8)  # ir_version = 8
        + _len_delimited(7, graph)  # graph
    )
    with open(path, "wb") as f:
        f.write(model)


# -- graph parsing (nodes + attributes), for models.onnx_exec ---------------


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str] = field(default_factory=list)
    outputs: List[str] = field(default_factory=list)
    name: str = ""
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode] = field(default_factory=list)
    initializers: Dict[str, np.ndarray] = field(default_factory=dict)
    inputs: List[str] = field(default_factory=list)   # graph inputs (names)
    outputs: List[str] = field(default_factory=list)  # graph outputs (names)


def _parse_attribute(buf: bytes) -> Tuple[str, object]:
    """AttributeProto -> (name, python value). Scalar f/i/s, tensor t, and
    repeated floats/ints/strings cover every attribute torch-exported
    vision graphs use."""
    pos = 0
    name = ""
    value: object = None
    floats: List[float] = []
    ints: List[int] = []
    strings: List[str] = []
    n = len(buf)
    while pos < n:
        fld, wt, pos = _read_field_header(buf, pos)
        if fld == 1 and wt == 2:  # name
            ln, pos = _read_varint(buf, pos)
            name = buf[pos : pos + ln].decode("utf-8")
            pos += ln
        elif fld == 2 and wt == 5:  # f (float)
            value = struct.unpack("<f", buf[pos : pos + 4])[0]
            pos += 4
        elif fld == 3 and wt == 0:  # i (int)
            v, pos = _read_varint(buf, pos)
            value = _to_signed64(v)
        elif fld == 4 and wt == 2:  # s (bytes -> str)
            ln, pos = _read_varint(buf, pos)
            value = buf[pos : pos + ln].decode("utf-8", errors="replace")
            pos += ln
        elif fld == 5 and wt == 2:  # t (tensor)
            ln, pos = _read_varint(buf, pos)
            _tname, arr = _parse_tensor(buf[pos : pos + ln])
            value = arr
            pos += ln
        elif fld == 7:  # floats (packed or unpacked fixed32)
            if wt == 2:
                ln, pos = _read_varint(buf, pos)
                floats.extend(
                    struct.unpack(f"<{ln // 4}f", buf[pos : pos + ln])
                )
                pos += ln
            else:
                floats.append(struct.unpack("<f", buf[pos : pos + 4])[0])
                pos += 4
        elif fld == 8:  # ints (packed or unpacked varint)
            if wt == 2:
                ln, pos = _read_varint(buf, pos)
                end = pos + ln
                while pos < end:
                    v, pos = _read_varint(buf, pos)
                    ints.append(_to_signed64(v))
            else:
                v, pos = _read_varint(buf, pos)
                ints.append(_to_signed64(v))
        elif fld == 9 and wt == 2:  # strings
            ln, pos = _read_varint(buf, pos)
            strings.append(buf[pos : pos + ln].decode("utf-8", errors="replace"))
            pos += ln
        else:  # type tag (20), graphs, doc strings, ...
            pos = _skip_field(buf, pos, wt)
    if floats:
        value = floats
    elif ints:
        value = ints
    elif strings:
        value = strings
    return name, value


def _parse_node(buf: bytes) -> OnnxNode:
    node = OnnxNode(op_type="")
    pos = 0
    n = len(buf)
    while pos < n:
        fld, wt, pos = _read_field_header(buf, pos)
        if fld == 1 and wt == 2:  # input
            ln, pos = _read_varint(buf, pos)
            node.inputs.append(buf[pos : pos + ln].decode("utf-8"))
            pos += ln
        elif fld == 2 and wt == 2:  # output
            ln, pos = _read_varint(buf, pos)
            node.outputs.append(buf[pos : pos + ln].decode("utf-8"))
            pos += ln
        elif fld == 3 and wt == 2:  # name
            ln, pos = _read_varint(buf, pos)
            node.name = buf[pos : pos + ln].decode("utf-8")
            pos += ln
        elif fld == 4 and wt == 2:  # op_type
            ln, pos = _read_varint(buf, pos)
            node.op_type = buf[pos : pos + ln].decode("utf-8")
            pos += ln
        elif fld == 5 and wt == 2:  # attribute
            ln, pos = _read_varint(buf, pos)
            aname, avalue = _parse_attribute(buf[pos : pos + ln])
            pos += ln
            if aname:
                node.attrs[aname] = avalue
        else:
            pos = _skip_field(buf, pos, wt)
    return node


def _value_info_name(buf: bytes) -> str:
    pos = 0
    n = len(buf)
    while pos < n:
        fld, wt, pos = _read_field_header(buf, pos)
        if fld == 1 and wt == 2:
            ln, pos = _read_varint(buf, pos)
            return buf[pos : pos + ln].decode("utf-8")
        pos = _skip_field(buf, pos, wt)
    return ""


def read_onnx_model(path: str) -> OnnxGraph:
    """Parse an .onnx file into an executable OnnxGraph (nodes in file
    order — the ONNX spec requires topological order; onnx_exec re-checks
    at run time). Graph ``inputs`` excludes initializer names (torch
    exports list weights under graph.input in some opset/exporter combos)."""
    with open(path, "rb") as f:
        buf = f.read()
    g = OnnxGraph()
    pos = 0
    n = len(buf)
    while pos < n:
        fld, wt, pos = _read_field_header(buf, pos)
        if fld == 7 and wt == 2:  # ModelProto.graph
            ln, pos = _read_varint(buf, pos)
            graph = buf[pos : pos + ln]
            pos += ln
            gpos = 0
            gn = len(graph)
            while gpos < gn:
                gfld, gwt, gpos = _read_field_header(graph, gpos)
                if gfld == 1 and gwt == 2:  # node
                    tln, gpos = _read_varint(graph, gpos)
                    g.nodes.append(_parse_node(graph[gpos : gpos + tln]))
                    gpos += tln
                elif gfld == 5 and gwt == 2:  # initializer
                    tln, gpos = _read_varint(graph, gpos)
                    name, arr = _parse_tensor(graph[gpos : gpos + tln])
                    gpos += tln
                    if name:
                        g.initializers[name] = arr
                elif gfld == 11 and gwt == 2:  # graph input
                    tln, gpos = _read_varint(graph, gpos)
                    g.inputs.append(_value_info_name(graph[gpos : gpos + tln]))
                    gpos += tln
                elif gfld == 12 and gwt == 2:  # graph output
                    tln, gpos = _read_varint(graph, gpos)
                    g.outputs.append(_value_info_name(graph[gpos : gpos + tln]))
                    gpos += tln
                else:
                    gpos = _skip_field(graph, gpos, gwt)
        else:
            pos = _skip_field(buf, pos, wt)
    g.inputs = [i for i in g.inputs if i and i not in g.initializers]
    return g


def read_onnx_initializers(path: str) -> Dict[str, np.ndarray]:
    """Parse an .onnx file and return {initializer name: array}."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = 0
    out: Dict[str, np.ndarray] = {}
    n = len(buf)
    # ModelProto scan
    while pos < n:
        field, wt, pos = _read_field_header(buf, pos)
        if field == 7 and wt == 2:  # graph
            ln, pos = _read_varint(buf, pos)
            graph = buf[pos : pos + ln]
            pos += ln
            gpos = 0
            gn = len(graph)
            while gpos < gn:
                gfield, gwt, gpos = _read_field_header(graph, gpos)
                if gfield == 5 and gwt == 2:  # initializer
                    tln, gpos = _read_varint(graph, gpos)
                    name, arr = _parse_tensor(graph[gpos : gpos + tln])
                    gpos += tln
                    if name:
                        out[name] = arr
                else:
                    gpos = _skip_field(graph, gpos, gwt)
        else:
            pos = _skip_field(buf, pos, wt)
    return out


# -- full-graph writer (executable models, not just weight containers) ------


def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    """TensorProto bytes: dims(1), data_type(2), name(8), raw_data(9).
    Raises on dtypes outside the reader's set — silently casting (the
    way the weights-container writer does) would change op semantics,
    e.g. int16 Div flips from truncating to float division."""
    arr = np.ascontiguousarray(arr)
    dt = _NP_TO_ONNX.get(arr.dtype)
    if dt is None:
        raise TypeError(
            f"unserializable tensor dtype {arr.dtype} for {name!r}"
        )
    t = b""
    for d in arr.shape:
        t += _varint(1 << 3) + _varint(d)
    t += _varint(2 << 3) + _varint(dt)
    if name:
        t += _len_delimited(8, name.encode("utf-8"))
    t += _len_delimited(9, arr.tobytes())
    return t


def _signed_varint(v: int) -> bytes:
    """Protobuf int64 varint: negatives as 64-bit two's complement."""
    return _varint(v & 0xFFFFFFFFFFFFFFFF)


def _attribute_proto(name: str, value: object) -> bytes:
    """AttributeProto bytes. Type inferred from the python value — the
    inverse of ``_parse_attribute``: float -> f(2), int -> i(3),
    str -> s(4), ndarray -> t(5), [float] -> floats(7), [int] -> ints(8),
    [str] -> strings(9). The ``type`` tag (20) is written so standard
    ONNX runtimes accept the file (our reader skips it).

    ``None`` and empty lists (both of which ``_parse_attribute`` yields
    for an empty repeated attribute) serialize as an empty INTS
    attribute and parse back as ``None`` — the reader's canonical
    representation, so re-writing a parsed graph never crashes."""
    a = _len_delimited(1, name.encode("utf-8"))
    if value is None or (isinstance(value, (list, tuple)) and not value):
        return a + _varint(20 << 3) + _varint(7)  # empty INTS
    if isinstance(value, np.ndarray):
        a += _len_delimited(5, _tensor_proto("", value))
        atype = 4  # TENSOR
    elif isinstance(value, bool):
        a += _varint(3 << 3) + _signed_varint(int(value))
        atype = 2
    elif isinstance(value, (int, np.integer)):
        a += _varint(3 << 3) + _signed_varint(int(value))
        atype = 2  # INT
    elif isinstance(value, (float, np.floating)):
        a += _varint((2 << 3) | 5) + struct.pack("<f", float(value))
        atype = 1  # FLOAT
    elif isinstance(value, str):
        a += _len_delimited(4, value.encode("utf-8"))
        atype = 3  # STRING
    elif isinstance(value, (list, tuple)):
        if value and all(isinstance(v, str) for v in value):
            for v in value:
                a += _len_delimited(9, v.encode("utf-8"))
            atype = 8  # STRINGS
        elif all(isinstance(v, (int, np.integer)) for v in value):
            a += _len_delimited(
                8, b"".join(_signed_varint(int(v)) for v in value))
            atype = 7  # INTS (packed)
        else:
            a += _len_delimited(
                7, b"".join(struct.pack("<f", float(v)) for v in value))
            atype = 6  # FLOATS (packed)
    else:
        raise TypeError(f"unserializable attribute {name!r}: {type(value)}")
    a += _varint(20 << 3) + _varint(atype)
    return a


def _node_proto(node: "OnnxNode") -> bytes:
    b = b""
    for i in node.inputs:
        b += _len_delimited(1, i.encode("utf-8"))
    for o in node.outputs:
        b += _len_delimited(2, o.encode("utf-8"))
    if node.name:
        b += _len_delimited(3, node.name.encode("utf-8"))
    b += _len_delimited(4, node.op_type.encode("utf-8"))
    for aname, avalue in node.attrs.items():
        b += _len_delimited(5, _attribute_proto(aname, avalue))
    return b


def _value_info_proto(name: str, dtype, shape) -> bytes:
    """ValueInfoProto: name(1) + type(2 -> TypeProto.tensor_type(1) ->
    elem_type(1), shape(2)). ``shape`` dims may be ints or strings
    (dim_param, e.g. a dynamic batch axis); None omits the shape."""
    vi = _len_delimited(1, name.encode("utf-8"))
    tt = b""
    dt = _NP_TO_ONNX.get(np.dtype(dtype)) if dtype is not None else None
    if dt is not None:
        tt += _varint(1 << 3) + _varint(dt)
    if shape is not None:
        sh = b""
        for d in shape:
            if isinstance(d, str):
                sh += _len_delimited(1, _len_delimited(2, d.encode("utf-8")))
            else:
                sh += _len_delimited(1, _varint(1 << 3) + _varint(int(d)))
        tt += _len_delimited(2, sh)
    if tt:
        vi += _len_delimited(2, _len_delimited(1, tt))
    return vi


def write_onnx_model(
    path: str,
    graph: "OnnxGraph",
    value_infos: Dict[str, tuple] | None = None,
    graph_name: str = "graph",
    opset: int = 17,
) -> None:
    """Serialize an executable OnnxGraph as a standard .onnx file
    (ir_version 8, default opset 17). ``value_infos`` optionally maps an
    input/output name to ``(numpy dtype, shape)`` — shape dims may be
    strings for dynamic axes — so standard runtimes see typed graph IO;
    names without an entry get a name-only ValueInfoProto (enough for
    ``read_onnx_model``, which ignores types). Round-trips through
    ``read_onnx_model`` exactly (nodes, attrs, initializers, IO names)."""
    value_infos = value_infos or {}
    g = b""
    for node in graph.nodes:
        g += _len_delimited(1, _node_proto(node))
    g += _len_delimited(2, graph_name.encode("utf-8"))
    for name, arr in graph.initializers.items():
        g += _len_delimited(5, _tensor_proto(name, np.asarray(arr)))
    for field_no, names in ((11, graph.inputs), (12, graph.outputs)):
        for name in names:
            dt, sh = value_infos.get(name, (None, None))
            g += _len_delimited(field_no, _value_info_proto(name, dt, sh))
    opset_proto = _varint(2 << 3) + _varint(opset)  # OperatorSetId.version
    model = (
        _varint(1 << 3) + _varint(8)  # ir_version = 8
        + _len_delimited(7, g)
        + _len_delimited(8, opset_proto)
    )
    with open(path, "wb") as f:
        f.write(model)
