"""Carry a model's weights across from the JAX package.

`dense_chain_from_arrays` builds the port's Dense-chain `Model` from the
numpy (matrix, bias) int64 arrays a JAX-package model holds;
`mlp_chain_from_arrays` builds the Dense -> Requant -> ReLU chain of
`bench.py`'s MLPs from the same arrays and each Requant's spec fields, so
that both packages prove the very same model.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from . import quantization as Q
from .layers.activation import Relu
from .layers.dense import Dense
from .layers.requant import Requant
from .model import Model
from .quantization import RequantSpec

SPEC_FIELDS = ("right_shift", "fixed_point_multiplier", "fp_scale", "multiplier", "intermediate_bit_size")


def _dense(matrix, bias, dev) -> Dense:
    return Dense(
        matrix=torch.from_numpy(np.asarray(matrix, dtype=np.int64)).to(dev),
        bias=torch.from_numpy(np.asarray(bias, dtype=np.int64)).to(dev),
    )


def dense_chain_from_arrays(layers, device="cuda") -> Model:
    """[(matrix (rows, cols), bias (rows,)), ...] -> a chain of Dense nodes."""
    dev = device_mod.resolve(device)
    model = Model()
    for matrix, bias in layers:
        model.add_chain(_dense(matrix, bias, dev))
    return model


def bench_requant_spec(dense: Dense, in_dim: int) -> RequantSpec:
    """The Requant that `bench.py`'s MLPs put after a Dense of `in_dim`
    inputs: multiplier 1 / 2^(BIT_LEN - 1) / in_dim."""
    return RequantSpec.from_multiplier(1.0 / (1 << (Q.BIT_LEN - 1)) / in_dim, dense.output_bitsize())


def mlp_chain_from_arrays(layers, requant_specs=None, device="cuda") -> Model:
    """[(matrix, bias), ...] -> Dense -> Requant -> ReLU per layer.

    requant_specs: one mapping of the RequantSpec fields per layer (a
    JAX-package spec's `dataclasses.asdict`); None derives them as
    `bench.py` does (`bench_requant_spec`)."""
    dev = device_mod.resolve(device)
    model = Model()
    for i, (matrix, bias) in enumerate(layers):
        dense = _dense(matrix, bias, dev)
        if requant_specs is None:
            spec = bench_requant_spec(dense, np.asarray(matrix).shape[1])
        else:
            spec = RequantSpec(**{f: requant_specs[i][f] for f in SPEC_FIELDS})
        model.add_chain(dense)
        model.add_chain(Requant(spec=spec))
        model.add_chain(Relu())
    return model
