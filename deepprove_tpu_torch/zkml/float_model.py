"""Float models and their quantization, as in the JAX package's
`zkml/float_model.py`.

A `FloatModel` is a DAG of float ops (dense, conv, pad, relu, maxpool,
flatten, residual add) evaluated with numpy. `quantize` turns it into a
provable quantized `Model`: weights are quantized per tensor, activations
either assumed in [-1, 1] ("absolute_max") or from the spans observed on
calibration inputs ("inference"), and a Requant follows every dense and
conv layer with the multiplier M = S_in S_w / S_out. A residual `FAdd`
requantizes both branches to its output scale, adds them, and renormalizes
the sum into the Element range. The arithmetic is the JAX package's, in
the same order, so both give the same integers.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from . import quantization as Q
from .layers.activation import Relu
from .layers.add import Add
from .layers.convolution import Convolution
from .layers.dense import Dense
from .layers.pad import Pad2D
from .layers.pooling import Maxpool2D
from .layers.requant import Requant
from .layers.shape_ops import Flatten
from .model import Edge, Model
from .quantization import RequantSpec, ScalingFactor
from .tensor import next_pow2


@dataclasses.dataclass
class FDense:
    weight: np.ndarray  # (rows, cols)
    bias: np.ndarray

    def forward(self, x):
        return self.weight @ x.reshape(-1) + self.bias


@dataclasses.dataclass
class FConv:
    weight: np.ndarray  # (kw, kx, k, k)
    bias: np.ndarray
    stride: int = 1

    def forward(self, x):
        """Valid cross-correlation embedded in the padded n x n grid, output
        channels padded to a power of two: the layout the quantized
        Convolution computes (its mask clears positions >= n - k + 1)."""
        from numpy.lib.stride_tricks import sliding_window_view

        kw, kx, k, _ = self.weight.shape
        _, n, _ = x.shape
        v = n - k + 1
        win = sliding_window_view(x[:kx], (k, k), axis=(1, 2))
        res = np.einsum("cyxij,ocij->oyx", win, self.weight)
        out = np.zeros((next_pow2(kw), n, n), dtype=np.float64)
        out[:kw, :v, :v] = res + self.bias[:, None, None]
        if self.stride > 1:
            out = np.ascontiguousarray(out[:, :: self.stride, :: self.stride])
        return out


@dataclasses.dataclass
class FPad:
    """Spatial zero-pad by `pad` on every edge (feeds padded convs)."""

    pad: int

    def forward(self, x):
        c, n, _ = x.shape
        n_out = next_pow2(n + 2 * self.pad)
        out = np.zeros((next_pow2(c), n_out, n_out), dtype=np.float64)
        out[:c, self.pad : self.pad + n, self.pad : self.pad + n] = x
        return out


@dataclasses.dataclass
class FRelu:
    def forward(self, x):
        return np.maximum(x, 0.0)


@dataclasses.dataclass
class FMaxpool:
    def forward(self, x):
        c, h, w = x.shape
        return x.reshape(c, h // 2, 2, w // 2, 2).max(axis=(2, 4))


@dataclasses.dataclass
class FFlatten:
    def forward(self, x):
        return x.reshape(-1)


@dataclasses.dataclass
class FAdd:
    """Element-wise residual add of two producer outputs."""

    def forward(self, a, b):
        return a + b


class FloatModel:
    """DAG of float ops: `add(op)` chains onto the previous node,
    `add_node(op, inputs)` wires explicit edges (input id -1 = the model
    input)."""

    def __init__(self, input_shape: tuple):
        self.ops: list = []  # (op, [input ids])
        self.input_shape = tuple(input_shape)

    def add(self, op):
        self.ops.append((op, [len(self.ops) - 1]))
        return self

    def add_node(self, op, inputs: list[int]) -> int:
        self.ops.append((op, list(inputs)))
        return len(self.ops) - 1

    def forward(self, x: np.ndarray, tracker=None) -> np.ndarray:
        vals: dict[int, np.ndarray] = {-1: x}
        out = x
        for i, (op, inputs) in enumerate(self.ops):
            out = op.forward(*[vals[j] for j in inputs])
            vals[i] = out
            if tracker is not None:
                tracker.observe(i, out)
        return out


class InferenceTracker:
    """Per-op output span observation (the inference observer)."""

    def __init__(self):
        self.span: dict[int, tuple] = {}

    def observe(self, op_idx: int, out: np.ndarray):
        lo = float(out.min()) if out.size else 0.0
        hi = float(out.max()) if out.size else 0.0
        if op_idx in self.span:
            plo, phi = self.span[op_idx]
            lo, hi = min(lo, plo), max(hi, phi)
        self.span[op_idx] = (lo, hi)


def _quantized_bias(op, s_in: ScalingFactor, s_w: ScalingFactor) -> np.ndarray:
    return np.clip(np.round(op.bias / (s_in.scale * s_w.scale)), -(1 << 25), 1 << 25).astype(np.int64)


def quantize(model: FloatModel, strategy: str = "absolute_max", calibration_inputs: list | None = None,
             device="cuda") -> tuple[Model, ScalingFactor, ScalingFactor]:
    """FloatModel -> (provable quantized Model on `device`, input scale,
    output scale).

    strategy: "absolute_max" (activations assumed in [-1, 1]) or
    "inference" (per-op output spans and the input's span observed on the
    calibration inputs)."""
    dev = device_mod.resolve(device)
    out_scales: dict[int, ScalingFactor] = {}
    input_scale = ScalingFactor.from_absolute_max(1.0)
    if strategy == "inference":
        assert calibration_inputs, "inference observer needs calibration inputs"
        tracker = InferenceTracker()
        for x in calibration_inputs:
            model.forward(np.asarray(x, dtype=np.float64), tracker)
        for i in range(len(model.ops)):
            lo, hi = tracker.span.get(i, (-1.0, 1.0))
            out_scales[i] = ScalingFactor.from_absolute_max(max(abs(lo), abs(hi), 1e-6))
        mx_in = max(max(float(np.max(np.abs(np.asarray(x)))) for x in calibration_inputs), 1e-6)
        input_scale = ScalingFactor.from_absolute_max(mx_in)
    else:
        for i in range(len(model.ops)):
            out_scales[i] = ScalingFactor.from_absolute_max(1.0)

    def tensor(a):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(dev)

    q = Model()
    produced: dict[int, tuple] = {}  # float node -> (quantized node, scale, shape)

    def shape_of(i):
        return model.input_shape if i == -1 else produced[i][2]

    def scale_of(i):
        return input_scale if i == -1 else produced[i][1]

    def edge_of(i):
        return Edge(node=None, index=0) if i == -1 else Edge(node=produced[i][0], index=0)

    last = None
    for i, (op, inputs) in enumerate(model.ops):
        if isinstance(op, FAdd):
            s_out = out_scales[i]
            branches = []
            for b in inputs:
                spec = RequantSpec.from_multiplier(scale_of(b).scale / s_out.scale, Q.BIT_LEN + 2)
                branches.append(Edge(node=q.add_node(Requant(spec=spec), [edge_of(b)]), index=0))
            nid = q.add_node(Add(), branches)
            # renormalize the (BIT_LEN + 1)-bit sum into the Element range
            half = ScalingFactor.from_absolute_max(2.0 * abs(s_out.max))
            spec = RequantSpec.from_multiplier(s_out.scale / half.scale, Q.BIT_LEN + 2)
            produced[i] = (q.add_node(Requant(spec=spec), [Edge(node=nid, index=0)]), half, shape_of(inputs[0]))
            last = i
            continue
        (src,) = inputs
        if isinstance(op, FPad):
            pad = Pad2D(pad=op.pad, input_shape=shape_of(src))
            produced[i] = (q.add_node(pad, [edge_of(src)]), scale_of(src), (pad.c, pad.n_out, pad.n_out))
        elif isinstance(op, (FDense, FConv)):
            s_in = scale_of(src)
            s_w = ScalingFactor.from_tensor(op.weight)
            s_out = out_scales[i]
            w_q, b_q = tensor(s_w.quantize(op.weight)), tensor(_quantized_bias(op, s_in, s_w))
            if isinstance(op, FDense):
                layer = Dense(matrix=w_q, bias=b_q)
                shape = (op.weight.shape[0],)
            else:
                layer = Convolution(filter=w_q, bias=b_q, input_shape=shape_of(src), stride=op.stride)
                n_out = layer.n // layer.stride
                shape = (layer.kw, n_out, n_out)
            nid = q.add_node(layer, [edge_of(src)])
            spec = RequantSpec.from_multiplier(s_in.m(s_w, s_out), layer.output_bitsize())
            nid = q.add_node(Requant(spec=spec), [Edge(node=nid, index=0)])
            produced[i] = (nid, s_out, shape)
        elif isinstance(op, FRelu):
            produced[i] = (q.add_node(Relu(), [edge_of(src)]), scale_of(src), shape_of(src))
        elif isinstance(op, FMaxpool):
            c, h, w = shape_of(src)
            pool = Maxpool2D(input_shape=(c, h, w))
            produced[i] = (q.add_node(pool, [edge_of(src)]), scale_of(src), (c, h // 2, w // 2))
        elif isinstance(op, FFlatten):
            shape = (int(np.prod(shape_of(src))),)
            produced[i] = (q.add_node(Flatten(), [edge_of(src)]), scale_of(src), shape)
        else:
            raise NotImplementedError(type(op))
        last = i
    return q, input_scale, produced[last][1]
