"""The model-level padding pass, as in the JAX package's `zkml/padding.py`.

The quantized pipeline computes on padded grids: `Convolution` embeds the
valid (n - k + 1)^2 window in the full n x n grid and pads output channels
to a power of two, clearing the rest to 0. `pad_pass` tracks, per float
node, the padded shape the pipeline computes on and the valid sub-shape
holding real data; at a conv -> (pool ...) -> flatten -> dense boundary it
zero-expands the dense weight's columns from the valid layout to the
padded one, and it rejects maxpools whose 2 x 2 windows would straddle the
valid/garbage boundary. It mutates FDense weights in place, is idempotent,
and returns {node id: (padded shape, valid shape)}.
"""

from __future__ import annotations

import numpy as np

from .float_model import FAdd, FConv, FDense, FMaxpool
from .tensor import next_pow2


def pad_pass(model) -> dict[int, tuple]:
    """Shape-infer the float DAG and rewrite dense weights over garbage.
    Shapes stay structured through FFlatten so the dense rule can remap
    columns."""
    padded: dict[int, tuple] = {-1: tuple(model.input_shape)}
    valid: dict[int, tuple] = {-1: tuple(model.input_shape)}
    for i, (op, inputs) in enumerate(model.ops):
        if isinstance(op, FDense):
            (s,) = inputs
            fp, fv = int(np.prod(padded[s])), int(np.prod(valid[s]))
            rows, cols = op.weight.shape
            if cols == fv and cols != fp:
                w = op.weight.reshape((rows,) + tuple(valid[s]))
                wp = np.zeros((rows,) + tuple(padded[s]), dtype=op.weight.dtype)
                wp[(slice(None),) + tuple(slice(0, d) for d in valid[s])] = w
                op.weight = wp.reshape(rows, fp)
            elif cols != fp:
                raise ValueError(f"dense weight has {cols} columns; input is {fv} valid / {fp} padded")
            padded[i] = valid[i] = (rows,)
        elif isinstance(op, FConv):
            (s,) = inputs
            _, n, n2 = padded[s]
            if n != n2:
                raise NotImplementedError("conv inputs must be square")
            cv, hv, wv = valid[s]
            co, ci, k, _ = op.weight.shape
            if ci != cv:
                raise ValueError(f"conv expects {ci} input channels, valid input has {cv}")
            padded[i] = (next_pow2(co), n, n)
            valid[i] = (co, hv - k + 1, wv - k + 1)
        elif isinstance(op, FMaxpool):
            (s,) = inputs
            c, h, w = padded[s]
            cv, hv, wv = valid[s]
            if (hv < h and hv % 2) or (wv < w and wv % 2):
                raise NotImplementedError("maxpool window would straddle the valid/garbage boundary")
            padded[i] = (c, h // 2, w // 2)
            valid[i] = (cv, hv // 2, wv // 2)
        elif isinstance(op, FAdd):
            a, b = inputs
            if padded[a] != padded[b] or valid[a] != valid[b]:
                raise NotImplementedError("residual add across differing padded/valid shapes")
            padded[i], valid[i] = padded[a], valid[a]
        else:
            # relu, flatten and other ops without spatial garbage: pass through
            (s,) = inputs
            padded[i], valid[i] = padded[s], valid[s]
    return {i: (padded[i], valid[i]) for i in padded}
