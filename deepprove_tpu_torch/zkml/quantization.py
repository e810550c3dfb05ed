"""Symmetric quantization constants and the Element -> field map.

Element = int64; BIT_LEN-bit symmetric range [MIN, MAX] =
[-(2^(b-1)) + 1, 2^(b-1) - 1], as in the JAX package's
`zkml/quantization.py`. `to_field` maps negatives to p - |x|.
"""

from __future__ import annotations

import os

import torch

from ..fields.gf import P_I64

BIT_LEN = int(os.environ.get("ZKML_BIT_LEN", "8"))
MIN = -(1 << (BIT_LEN - 1)) + 1
MAX = (1 << (BIT_LEN - 1)) - 1


def to_field(x: torch.Tensor) -> torch.Tensor:
    """int64 Elements -> canonical Goldilocks (int64 bit patterns)."""
    return torch.where(x < 0, x + P_I64, x)
