"""Carry a model's weights across from the JAX package.

`dense_chain_from_arrays` builds the port's Dense-chain `Model` from the
numpy (matrix, bias) int64 arrays a JAX-package model holds, so that both
packages prove the very same model.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import device as device_mod
from .layers.dense import Dense
from .model import Model


def dense_chain_from_arrays(layers, device="cuda") -> Model:
    """[(matrix (rows, cols), bias (rows,)), ...] -> a chain of Dense nodes."""
    dev = device_mod.resolve(device)
    model = Model()
    for matrix, bias in layers:
        model.add_chain(
            Dense(
                matrix=torch.from_numpy(np.asarray(matrix, dtype=np.int64)).to(dev),
                bias=torch.from_numpy(np.asarray(bias, dtype=np.int64)).to(dev),
            )
        )
    return model
