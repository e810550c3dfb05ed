"""Shape-only ops, as in the JAX package's `zkml/layers/shape_ops.py`:
Flatten and Reshape. Not provable: the reshaped data is the same
polynomial, so claims pass through them unchanged."""

from __future__ import annotations

import dataclasses

from ..tensor import Tensor


@dataclasses.dataclass
class Flatten:
    @property
    def is_provable(self) -> bool:
        return False

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(inputs[0].data.reshape(-1))]

    def step_info(self, node_id: int, aux):
        return FlattenCtx()


@dataclasses.dataclass
class FlattenCtx:
    @property
    def is_provable(self) -> bool:
        return False


@dataclasses.dataclass
class Reshape:
    shape: tuple

    @property
    def is_provable(self) -> bool:
        return False

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(inputs[0].data.reshape(self.shape))]

    def step_info(self, node_id: int, aux):
        return FlattenCtx()
