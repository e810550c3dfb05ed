"""Quantized tensors: int64 Elements in a torch tensor on the model's device."""

from __future__ import annotations

import dataclasses

import torch

from . import quantization as Q


def ceil_log2(n: int) -> int:
    return max(0, (int(n) - 1).bit_length())


def next_pow2(n: int) -> int:
    return 1 << ceil_log2(n)


@dataclasses.dataclass
class Tensor:
    data: torch.Tensor  # int64 elements

    @property
    def shape(self) -> tuple:
        return tuple(self.data.shape)

    def flat(self) -> torch.Tensor:
        return self.data.reshape(-1)

    def num_vars(self) -> int:
        return ceil_log2(self.flat().numel())

    def to_field(self) -> torch.Tensor:
        """Pad to a power of two and lift to the field, on the tensor's device."""
        flat = self.flat()
        padded = torch.zeros(next_pow2(flat.numel()), dtype=torch.int64, device=flat.device)
        padded[: flat.numel()] = flat
        return Q.to_field(padded)


def pad_vec_pow2(v: torch.Tensor) -> torch.Tensor:
    """Flatten and pad with zeros to a power of two."""
    out = torch.zeros(next_pow2(v.numel()), dtype=torch.int64, device=v.device)
    out[: v.numel()] = v.reshape(-1)
    return out


def pad_matrix_pow2(w: torch.Tensor) -> torch.Tensor:
    """Pad both dims of a matrix to powers of two with zeros."""
    r, c = w.shape
    out = torch.zeros((next_pow2(r), next_pow2(c)), dtype=torch.int64, device=w.device)
    out[:r, :c] = w
    return out
