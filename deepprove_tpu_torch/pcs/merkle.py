"""Merkle trees over Poseidon2 (device levels, host paths).

As in the JAX package's `pcs/merkle.py` (Poseidon half):
  * leaf-pair digest = hash_or_noop packing: a pair of base elements
    (a, b) -> [a, b, 0, 0]; a pair of ext elements -> [a0, a1, b0, b1];
  * inner nodes = two_to_one compression, one whole level per call of
    `poseidon2_cuda.compress_level` (the CUDA kernel on the card), the
    levels of equal-size trees built together in one call.

Levels are plane-major int64 (4, M) tensors, row e holding element e of
every digest. A root is a (4,) device tensor (`root_dev`) or a 4-tuple of
ints (`root`); host paths are (Q, depth, 4) uint64 arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fields import gf
from ..fields.gf import GF2
from ..hashing.poseidon2_cuda import compress_level

Digest = tuple[int, int, int, int]


def leaf_digests(leaves) -> torch.Tensor:
    """Leaves (N,) base or GF2 -> (4, N/2) pair-digest planes.

    A single base leaf packs to one digest [a, 0, 0, 0]."""
    if isinstance(leaves, GF2):
        return torch.stack(
            [leaves.a0[0::2], leaves.a1[0::2], leaves.a0[1::2], leaves.a1[1::2]]
        )
    n = leaves.shape[0]
    if n == 1:
        z = torch.zeros_like(leaves)
        return torch.stack([leaves, z, z, z])
    z = gf.zeros((n // 2,), leaves.device)
    return torch.stack([leaves[0::2], leaves[1::2], z, z])


def tree_levels_many(leaves_list) -> list:
    """Every digest level, from the leaf-pair digests up to the (4, 1) root,
    of each of several equal-length leaf arrays. The trees are hashed side
    by side, one `compress_level` call a level for all of them: each tree's
    level width stays even until its root, so no pair straddles two trees."""
    b = len(leaves_list)
    levels = [torch.cat([leaf_digests(leaves) for leaves in leaves_list], dim=1)]
    while levels[-1].shape[1] > b:
        levels.append(compress_level(levels[-1]))
    return [[lvl.reshape(4, b, -1)[:, i] for lvl in levels] for i in range(b)]


@dataclasses.dataclass
class MerkleTree:
    """Digest levels; levels[0] = leaf-pair digests, levels[-1] the root."""

    leaves: object  # base (N,) | GF2 (N,) -- bit-reversed codeword
    levels: list  # int64 (4, M) digest planes

    @staticmethod
    def from_leaves(leaves) -> "MerkleTree":
        return MerkleTree.from_leaves_many([leaves])[0]

    @staticmethod
    def from_leaves_many(leaves_list) -> list:
        """One tree per leaf array; arrays of one length are hashed together
        (`tree_levels_many`)."""
        by_len: dict = {}
        for i, leaves in enumerate(leaves_list):
            by_len.setdefault(leaves.shape[0], []).append(i)
        trees = [None] * len(leaves_list)
        for idx in by_len.values():
            for i, levels in zip(idx, tree_levels_many([leaves_list[i] for i in idx])):
                trees[i] = MerkleTree(leaves=leaves_list[i], levels=levels)
        return trees

    @property
    def root_dev(self) -> torch.Tensor:
        """The root digest as a (4,) int64 tensor on the tree's device."""
        return self.levels[-1][:, 0]

    @property
    def root(self) -> Digest:
        """The root as host ints (one read)."""
        return tuple(gf.to_u64(self.root_dev).tolist())

    @property
    def depth(self) -> int:
        return len(self.levels) - 1

    def paths_dev(self, pair_idx: torch.Tensor) -> torch.Tensor:
        """Sibling digests on the way up from leaf pairs `pair_idx` (Q,):
        (Q, depth, 4) on the device."""
        idx = pair_idx
        sibs = []
        for lvl in self.levels[:-1]:
            sibs.append(lvl[:, idx ^ 1].T)
            idx = idx >> 1
        return torch.stack(sibs, dim=1)

    def paths(self, pair_indices) -> np.ndarray:
        """Host (Q, depth, 4) uint64 paths - one pull."""
        q = len(pair_indices)
        if self.depth == 0:
            return np.empty((q, 0, 4), dtype=np.uint64)
        dev = self.levels[0].device
        idx = torch.as_tensor(np.asarray(pair_indices, dtype=np.int64), device=dev)
        return gf.to_u64(self.paths_dev(idx))
