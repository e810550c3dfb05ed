"""Symmetric quantization constants, the Element -> field map and the
requantization spec, and the scaling factors of float quantization.

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

import numpy as np
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
class ScalingFactor:
    """A float span and its scale onto the Element domain (host numpy), as
    in the JAX package's `zkml/quantization.py`."""

    min: float
    max: float
    scale: float
    domain: tuple = (MIN, MAX)

    @staticmethod
    def from_absolute_max(abs_max: float, domain=None) -> "ScalingFactor":
        return ScalingFactor.from_span(-abs(abs_max), abs(abs_max), domain)

    @staticmethod
    def from_span(mn: float, mx: float, domain=None) -> "ScalingFactor":
        domain = domain or (MIN, MAX)
        return ScalingFactor(min=mn, max=mx, scale=(mx - mn) / float(domain[1] - domain[0]), domain=domain)

    @staticmethod
    def from_tensor(data: np.ndarray, domain=None) -> "ScalingFactor":
        return ScalingFactor.from_absolute_max(float(np.max(np.abs(data))), domain)

    def m(self, s2: "ScalingFactor", s3: "ScalingFactor") -> float:
        """The requant multiplier M = S1 S2 / S3."""
        return self.scale * s2.scale / s3.scale

    def quantize(self, values) -> np.ndarray:
        q = np.round(np.asarray(values, dtype=np.float64) / self.scale).astype(np.int64)
        return np.clip(q, self.domain[0], self.domain[1])

    def dequantize(self, values) -> np.ndarray:
        return np.asarray(values, dtype=np.float64) * self.scale


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
