"""Symmetric quantization constants, the Element -> field map and the
requantization spec.

Element = int64; BIT_LEN-bit symmetric range [MIN, MAX] =
[-(2^(b-1)) + 1, 2^(b-1) - 1], as in the JAX package's
`zkml/quantization.py`. `to_field` maps negatives to p - |x|. A requant
multiplier M is split into a right shift and a fixed-point multiplier at
scale >= 2^25 (`RequantSpec.from_multiplier`).
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch

from ..fields.gf import P_I64

BIT_LEN = int(os.environ.get("ZKML_BIT_LEN", "8"))
MIN = -(1 << (BIT_LEN - 1)) + 1
MAX = (1 << (BIT_LEN - 1)) - 1
FIXED_POINT_SCALE = 25


def to_field(x: torch.Tensor) -> torch.Tensor:
    """int64 Elements -> canonical Goldilocks (int64 bit patterns)."""
    return torch.where(x < 0, x + P_I64, x)


@dataclasses.dataclass(frozen=True)
class RequantSpec:
    """Requant op parameters: out = clamp((v * fpm + 2^(shift-1)) >> shift)."""

    right_shift: int
    fixed_point_multiplier: int
    fp_scale: int
    multiplier: float
    intermediate_bit_size: int

    @staticmethod
    def from_multiplier(multiplier: float, intermediate_bit_size: int) -> "RequantSpec":
        log_m = math.log2(multiplier)
        int_part = int(abs(math.trunc(log_m)))
        epsilon = 2.0 ** (log_m - math.trunc(log_m))
        # fp_scale: the smallest >= FIXED_POINT_SCALE with fp_scale + right_shift
        # a multiple of BIT_LEN, so the shifted chunks fill whole range tables
        total = int_part + FIXED_POINT_SCALE
        fp_scale = ((total + BIT_LEN - 1) // BIT_LEN) * BIT_LEN - int_part
        # back off by whole BIT_LEN chunks until v * fpm fits in int64
        while intermediate_bit_size + fp_scale > 63 and fp_scale > BIT_LEN:
            fp_scale -= BIT_LEN
        fpm = int(round(epsilon * (1 << fp_scale)))
        assert intermediate_bit_size + fp_scale <= 63, (intermediate_bit_size, fp_scale, int_part)
        return RequantSpec(
            right_shift=int_part,
            fixed_point_multiplier=fpm,
            fp_scale=fp_scale,
            multiplier=multiplier,
            intermediate_bit_size=intermediate_bit_size,
        )

    @property
    def shift(self) -> int:
        return self.fp_scale + self.right_shift

    def clamping_size(self) -> int:
        fpm_bits = max(1, (self.fixed_point_multiplier - 1).bit_length())
        return self.intermediate_bit_size + fpm_bits - self.shift

    def apply(self, values: torch.Tensor) -> torch.Tensor:
        """Fixed-point multiply, round, arithmetic shift, clamp (int64)."""
        unclamped = (values * self.fixed_point_multiplier + (1 << (self.shift - 1))) >> self.shift
        return unclamped.clamp(MIN, MAX)
