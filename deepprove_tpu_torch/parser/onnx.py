"""ONNX model loader -> the port's FloatModel, a copy of the JAX package's
`parser/onnx.py` (which it may not import).

Reads the ModelProto directly off the protobuf wire (no onnx package is
needed). Supported ops, the MLP/CNN set: Gemm, MatMul + Add, Relu, Conv
(square kernel, pow2 stride, uniform padding), MaxPool (2x2/2), Flatten,
Reshape. A padded Conv gives the FloatModel an `FPad` before its `FConv`,
and an Add of two node outputs a residual `FAdd`.
"""

from __future__ import annotations

import numpy as np

from ..zkml.float_model import (
    FAdd,
    FConv,
    FDense,
    FFlatten,
    FMaxpool,
    FPad,
    FRelu,
    FloatModel,
)
from ..zkml.padding import pad_pass
from .protobuf import get_ints, parse_message

# ONNX TensorProto data types
FLOAT = 1
INT64 = 7


def _parse_tensor(buf: bytes):
    msg = parse_message(buf)
    dims = get_ints(msg, 1)
    dtype = get_ints(msg, 2)
    dtype = dtype[0] if dtype else FLOAT
    name = msg.get(8, [b""])[0].decode()
    raw = msg.get(9, [None])[0]
    if raw is not None:
        if dtype == FLOAT:
            data = np.frombuffer(raw, dtype="<f4").astype(np.float64)
        elif dtype == INT64:
            data = np.frombuffer(raw, dtype="<i8").astype(np.int64)
        else:
            raise ValueError(f"unsupported tensor dtype {dtype}")
    elif 4 in msg:  # packed float_data
        floats = []
        for v in msg[4]:
            if isinstance(v, bytes) and len(v) == 4:
                floats.append(np.frombuffer(v, dtype="<f4")[0])
            else:
                floats.extend(np.frombuffer(v, dtype="<f4"))
        data = np.asarray(floats, dtype=np.float64)
    elif 7 in msg:  # int64_data
        data = np.asarray(get_ints(msg, 7), dtype=np.int64)
    else:
        data = np.zeros(0)
    if dims:
        data = data.reshape(dims)
    return name, data


def _parse_attributes(node_msg: dict) -> dict:
    attrs = {}
    for a in node_msg.get(5, []):
        am = parse_message(a)
        name = am.get(1, [b""])[0].decode()
        if 3 in am:  # int
            attrs[name] = get_ints(am, 3)[0]
        elif 8 in am:  # ints
            attrs[name] = get_ints(am, 8)
        elif 2 in am:  # float (fixed32)
            attrs[name] = float(np.frombuffer(am[2][0], dtype="<f4")[0])
        elif 4 in am:  # string
            attrs[name] = am[4][0]
    return attrs


def _input_shape(graph: dict) -> tuple:
    """First graph input's tensor shape (batch dim dropped if 1/absent)."""
    for vi in graph.get(11, []):
        m = parse_message(vi)
        tp = parse_message(m[2][0])
        tt = parse_message(tp[1][0])
        if 2 not in tt:
            continue
        shape_msg = parse_message(tt[2][0])
        dims = []
        for d in shape_msg.get(1, []):
            dm = parse_message(d)
            dims.append(get_ints(dm, 1)[0] if 1 in dm else 0)
        if dims and dims[0] in (0, 1):
            dims = dims[1:]
        return tuple(dims)
    raise ValueError("no model input shape found")


def load_onnx(path: str) -> FloatModel:
    """Parse an .onnx file into a FloatModel DAG.

    Graph-structured (name-based edges) rather than chain-only: MatMul +
    Add bias fusion, a standalone residual Add between two node outputs,
    and the MLP/CNN op set. Ends with `pad_pass`.
    """
    with open(path, "rb") as f:
        model_msg = parse_message(f.read())
    graph = parse_message(model_msg[7][0])

    inits = {}
    for t in graph.get(5, []):
        name, data = _parse_tensor(t)
        inits[name] = data

    in_shape = _input_shape(graph)
    fm = FloatModel(input_shape=in_shape)

    # graph-input tensor names map to node id −1
    name_to_id: dict[str, int] = {}
    for vi in graph.get(11, []):
        m = parse_message(vi)
        nm_ = m.get(1, [b""])[0].decode()
        if nm_ and nm_ not in inits:
            name_to_id[nm_] = -1

    def src_id(name: str) -> int:
        if name in name_to_id:
            return name_to_id[name]
        if not name_to_id:  # tolerate missing value_info: first use = input
            return -1
        raise KeyError(f"ONNX tensor {name!r} has no producer")

    pending = {}  # output name -> transposed MatMul weight awaiting bias

    for nbuf in graph.get(1, []):
        nm = parse_message(nbuf)
        op_type = nm.get(4, [b""])[0].decode()
        node_inputs = [b.decode() for b in nm.get(1, [])]
        node_outputs = [b.decode() for b in nm.get(2, [])]
        attrs = _parse_attributes(nm)
        out_name = node_outputs[0] if node_outputs else ""

        if op_type == "Gemm":
            w = inits[node_inputs[1]]
            b = (
                inits[node_inputs[2]]
                if len(node_inputs) > 2
                else np.zeros(w.shape[0])
            )
            if attrs.get("transB", 0) == 0:
                w = w.T
            nid = fm.add_node(FDense(weight=w, bias=b), [src_id(node_inputs[0])])
            name_to_id[out_name] = nid
        elif op_type == "MatMul":
            w = inits[node_inputs[1]]
            pending[out_name] = (w.T, src_id(node_inputs[0]))
        elif op_type == "Add":
            init_ins = [n for n in node_inputs if n in inits]
            if len(init_ins) == 1 and any(n in pending for n in node_inputs):
                # bias add fused into the preceding MatMul
                mm_name = next(n for n in node_inputs if n in pending)
                w, sid = pending.pop(mm_name)
                b = inits[init_ins[0]].reshape(-1)
                nid = fm.add_node(FDense(weight=w, bias=b), [sid])
            else:
                # standalone residual add between two node outputs
                sids = []
                for n in node_inputs:
                    if n in pending:
                        w, sid0 = pending.pop(n)
                        sids.append(
                            fm.add_node(
                                FDense(weight=w, bias=np.zeros(w.shape[0])), [sid0]
                            )
                        )
                    else:
                        sids.append(src_id(n))
                nid = fm.add_node(FAdd(), sids)
            name_to_id[out_name] = nid
        elif op_type == "Relu":
            sname = node_inputs[0]
            if sname in pending:
                w, sid = pending.pop(sname)
                sid = fm.add_node(FDense(weight=w, bias=np.zeros(w.shape[0])), [sid])
            else:
                sid = src_id(sname)
            nid = fm.add_node(FRelu(), [sid])
            name_to_id[out_name] = nid
        elif op_type == "Conv":
            w = inits[node_inputs[1]]
            b = (
                inits[node_inputs[2]]
                if len(node_inputs) > 2
                else np.zeros(w.shape[0])
            )
            strides = attrs.get("strides", [1, 1])
            s = int(strides[0])
            assert list(strides) == [s, s] and s >= 1 and s & (s - 1) == 0, (
                "conv stride must be square power-of-two"
            )
            pads = attrs.get("pads", [0, 0, 0, 0])
            p = int(pads[0])
            assert list(pads) == [p, p, p, p], "conv padding must be uniform"
            sid = src_id(node_inputs[0])
            if p > 0:
                sid = fm.add_node(FPad(pad=p), [sid])
            nid = fm.add_node(FConv(weight=w, bias=b, stride=s), [sid])
            name_to_id[out_name] = nid
        elif op_type == "MaxPool":
            ks = attrs.get("kernel_shape", [2, 2])
            assert list(ks) == [2, 2], "2x2 maxpool only"
            nid = fm.add_node(FMaxpool(), [src_id(node_inputs[0])])
            name_to_id[out_name] = nid
        elif op_type in ("Flatten", "Reshape"):
            nid = fm.add_node(FFlatten(), [src_id(node_inputs[0])])
            name_to_id[out_name] = nid
        elif op_type in ("Identity", "Dropout", "Cast"):
            name_to_id[out_name] = src_id(node_inputs[0])
        else:
            raise NotImplementedError(f"ONNX op {op_type}")

    for out_name, (w, sid) in pending.items():
        fm.add_node(FDense(weight=w, bias=np.zeros(w.shape[0])), [sid])

    pad_pass(fm)  # zero-expand dense weights over the conv garbage
    return fm
