"""Carry a model's weights across from the JAX package.

`model_from_layers` builds any chain of the port's layers from
[(kind, fields)] numpy records (a JAX-package Model's layers);
`dense_chain_from_arrays` (Dense only) and `mlp_chain_from_arrays`
(Dense -> Requant -> ReLU, as `bench.py`'s MLPs) build their records from
(matrix, bias) int64 arrays, so that both packages prove the very same
model. `model_from_graph` builds a DAG of the port's layers, the
residual and transformer ones among them, from [(kind, fields, edges)]
records. `float_model_from_ops` builds a FloatModel from
[(kind, weight, bias, stride)] float arrays, `float_model_from_graph` a
DAG of float ops from [(kind, weight, bias, input ids)].
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from . import quantization as Q
from .float_model import FAdd, FConv, FDense, FFlatten, FloatModel, FMaxpool, FRelu
from .layers.activation import Gelu, Relu
from .layers.add import Add
from .layers.concat_matmul import ConcatMatMul, Permute
from .layers.convolution import Convolution
from .layers.dense import Dense
from .layers.embeddings import Embeddings, Positional
from .layers.layernorm import LayerNorm
from .layers.logits import Logits
from .layers.matmul import MatMul
from .layers.pad import Pad2D
from .layers.pooling import Maxpool2D
from .layers.qkv import QKV
from .layers.requant import Requant
from .layers.shape_ops import Flatten, Reshape
from .layers.softmax import Softmax
from .model import Edge, Model
from .quantization import RequantSpec

SPEC_FIELDS = ("right_shift", "fixed_point_multiplier", "fp_scale", "multiplier", "intermediate_bit_size")


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)


def model_from_layers(layers, device="cuda") -> Model:
    """A chain of the port's layers from [(kind, fields)] records:
      conv: filter (kw, kx, k, k), bias (kw,), input_shape, stride;
      dense: matrix (rows, cols), bias (rows,);
      requant: the RequantSpec fields, or only `multiplier`, the bit size
        then taken from the layer before (`output_bitsize`);
      maxpool: input_shape (c, h, w);
      relu, flatten: no fields."""
    dev = device_mod.resolve(device)
    model, prev = Model(), None
    for kind, f in layers:
        if kind == "conv":
            op = Convolution(
                filter=_tensor(f["filter"], dev), bias=_tensor(f["bias"], dev),
                input_shape=tuple(f["input_shape"]), stride=int(f["stride"]),
            )
        elif kind == "dense":
            op = Dense(matrix=_tensor(f["matrix"], dev), bias=_tensor(f["bias"], dev))
        elif kind == "requant":
            if set(f) == {"multiplier"}:
                spec = RequantSpec.from_multiplier(f["multiplier"], prev.output_bitsize())
            else:
                spec = RequantSpec(**{k: f[k] for k in SPEC_FIELDS})
            op = Requant(spec=spec)
        elif kind == "maxpool":
            op = Maxpool2D(input_shape=tuple(f["input_shape"]))
        else:
            op = {"relu": Relu, "flatten": Flatten}[kind]()
        model.add_chain(op)
        prev = op
    return model


def model_from_graph(nodes, num_inputs: int = 1, device="cuda") -> Model:
    """A DAG of the port's layers from [(kind, fields, edges)] records, edges
    [(producer position in `nodes` or None for a model input, wire)]:
      dense: matrix, bias; add; pad: pad, input_shape; conv: filter, bias,
      input_shape, stride; matmul: two witness inputs, or one and right,
      bias (MatMul.new_constant); embeddings, positional:
      table; requant: multiplier, bits (RequantSpec.from_multiplier); gelu:
      s_in, s_out; layernorm: gamma_f, beta_f, eps, s_in (LayerNorm.from_float);
      qkv: ws, bs (three each); permute: perm, in_shape; concat_matmul:
      transpose_b; softmax: s_in, max_size, temperature, seq, domain_max;
      reshape: shape; logits."""
    dev = device_mod.resolve(device)
    make = {
        "dense": lambda f: Dense(matrix=_tensor(f["matrix"], dev), bias=_tensor(f["bias"], dev)),
        "add": lambda f: Add(),
        "pad": lambda f: Pad2D(pad=f["pad"], input_shape=tuple(f["input_shape"])),
        "conv": lambda f: Convolution(filter=_tensor(f["filter"], dev), bias=_tensor(f["bias"], dev),
                                      input_shape=tuple(f["input_shape"]), stride=int(f["stride"])),
        "matmul": lambda f: (MatMul.new_constant(_tensor(f["right"], dev), _tensor(f["bias"], dev))
                             if "right" in f else MatMul()),
        "embeddings": lambda f: Embeddings(table=_tensor(f["table"], dev)),
        "positional": lambda f: Positional(table=_tensor(f["table"], dev)),
        "requant": lambda f: Requant(spec=RequantSpec.from_multiplier(f["multiplier"], f["bits"])),
        "gelu": lambda f: Gelu(s_in=f["s_in"], s_out=f["s_out"]),
        "layernorm": lambda f: LayerNorm.from_float(f["gamma_f"], f["beta_f"], eps=f["eps"], s_in=f["s_in"],
                                                    device=dev),
        "qkv": lambda f: QKV(ws=[_tensor(w, dev) for w in f["ws"]], bs=[_tensor(b, dev) for b in f["bs"]]),
        "permute": lambda f: Permute(tuple(f["perm"]), tuple(f["in_shape"])),
        "concat_matmul": lambda f: ConcatMatMul(transpose_b=f["transpose_b"]),
        "softmax": lambda f: Softmax(s_in=f["s_in"], max_size=f["max_size"], temperature=f["temperature"],
                                     seq=f["seq"], domain_max=f["domain_max"]),
        "reshape": lambda f: Reshape(tuple(f["shape"])),
        "logits": lambda f: Logits(),
    }
    model = Model(num_inputs=num_inputs)
    for kind, fields, edges in nodes:
        model.add_node(make[kind](fields), [Edge(node=n, index=i) for n, i in edges])
    return model


def dense_chain_from_arrays(layers, device="cuda") -> Model:
    """[(matrix (rows, cols), bias (rows,)), ...] -> a chain of Dense nodes."""
    return model_from_layers([("dense", dict(matrix=m, bias=b)) for m, b in layers], device)


def mlp_chain_from_arrays(layers, requant_specs=None, device="cuda") -> Model:
    """[(matrix, bias), ...] -> Dense -> Requant -> ReLU per layer.

    requant_specs: one mapping of the RequantSpec fields per layer (a
    JAX-package spec's `dataclasses.asdict`); None derives them as
    `bench.py` does, from the multiplier 1 / 2^(BIT_LEN - 1) / in_dim."""
    records = []
    for i, (matrix, bias) in enumerate(layers):
        if requant_specs is None:
            spec = {"multiplier": 1.0 / (1 << (Q.BIT_LEN - 1)) / np.asarray(matrix).shape[1]}
        else:
            spec = {f: requant_specs[i][f] for f in SPEC_FIELDS}
        records += [("dense", dict(matrix=matrix, bias=bias)), ("requant", spec), ("relu", {})]
    return model_from_layers(records, device)


def float_model_from_ops(input_shape, ops) -> FloatModel:
    """A FloatModel chain from [(kind, weight, bias, stride)] float arrays
    (kind conv, dense, relu, maxpool or flatten)."""
    fm = FloatModel(input_shape=input_shape)
    for kind, w, b, stride in ops:
        if kind == "conv":
            fm.add(FConv(weight=np.asarray(w, dtype=np.float64), bias=np.asarray(b, dtype=np.float64), stride=stride))
        elif kind == "dense":
            fm.add(FDense(weight=np.asarray(w, dtype=np.float64), bias=np.asarray(b, dtype=np.float64)))
        else:
            fm.add({"relu": FRelu, "maxpool": FMaxpool, "flatten": FFlatten}[kind]())
    return fm


def float_model_from_graph(input_shape, ops) -> FloatModel:
    """A FloatModel DAG from [(kind, weight, bias, input ids)] (kind dense,
    relu or add; input id -1 is the model input)."""
    fm = FloatModel(input_shape=input_shape)
    for kind, w, b, inputs in ops:
        if kind == "dense":
            op = FDense(weight=np.asarray(w, dtype=np.float64), bias=np.asarray(b, dtype=np.float64))
        else:
            op = {"relu": FRelu, "add": FAdd}[kind]()
        fm.add_node(op, list(inputs))
    return fm
