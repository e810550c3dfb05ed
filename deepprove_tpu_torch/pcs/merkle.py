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

A tree of more than 2^WHOLE_LOG leaf pairs keeps its levels of at most
2^KEEP_LOG digests only: the wider ones, four times its leaves' bytes for
a base codeword, are dropped as they are hashed, and a path rebuilds the
lower part of its way from the leaves, the queried pair's subtree alone.
Roots and paths are the same; a 2^28-pair tree keeps 4 MiB instead of 16
GiB. A smaller tree (every one of Dense-4M's and the LeNet's) keeps every
level, and its paths need no rebuild.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..fields import gf
from ..fields.gf import GF2
from ..hashing.poseidon2_cuda import compress_level

Digest = tuple[int, int, int, int]

WHOLE_LOG = 20
KEEP_LOG = 16


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


def dropped_levels(num_leaves: int) -> int:
    """The levels a tree over `num_leaves` leaves does not keep: none up to
    2^WHOLE_LOG pairs, else those wider than 2^KEEP_LOG digests."""
    pairs_log = (max(1, num_leaves // 2) - 1).bit_length()
    return 0 if pairs_log <= WHOLE_LOG else pairs_log - KEEP_LOG


def tree_levels_many(leaves_list) -> list:
    """The kept digest levels (`dropped_levels` of them left out), up to the
    (4, 1) root, of each of several equal-length leaf arrays. The trees are
    hashed side by side, one `compress_level` call a level for all of them:
    each tree's level width stays even until its root, so no pair straddles
    two trees."""
    b = len(leaves_list)
    drop = dropped_levels(leaves_list[0].shape[0])
    level = torch.cat([leaf_digests(leaves) for leaves in leaves_list], dim=1)
    levels = []
    for _ in range(drop):
        level = compress_level(level)
    levels.append(level)
    while levels[-1].shape[1] > b:
        levels.append(compress_level(levels[-1]))
    return [[lvl.reshape(4, b, -1)[:, i] for lvl in levels] for i in range(b)]


@dataclasses.dataclass
class MerkleTree:
    """Digest levels from level `dropped` up (level 0 = the leaf-pair
    digests), levels[-1] the root."""

    leaves: object  # base (N,) | GF2 (N,) -- bit-reversed codeword
    levels: list  # int64 (4, M) digest planes, from level `dropped` up
    dropped: int = 0  # the lowest levels, rebuilt from the leaves for a path

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
                trees[i] = MerkleTree(leaves=leaves_list[i], levels=levels,
                                      dropped=dropped_levels(leaves_list[i].shape[0]))
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
        return self.dropped + len(self.levels) - 1

    def _subtree_siblings(self, pair_idx: torch.Tensor) -> list:
        """The siblings on the dropped levels: each queried pair's subtree of
        2^dropped pairs hashed anew from the leaves, the subtrees side by
        side."""
        d, dev = self.dropped, pair_idx.device
        span = 1 << d
        q = pair_idx.shape[0]
        pairs = (((pair_idx >> d) << d)[:, None] + torch.arange(span, device=dev)).reshape(-1)
        level = leaf_digests(self.leaves[torch.stack([2 * pairs, 2 * pairs + 1], dim=1).reshape(-1)])
        sibs = []
        for k in range(d):
            width = span >> k
            local = (pair_idx >> k) & (width - 1)
            sibs.append(level[:, torch.arange(q, device=dev) * width + (local ^ 1)].T)
            level = compress_level(level)
        return sibs

    def paths_dev(self, pair_idx: torch.Tensor) -> torch.Tensor:
        """Sibling digests on the way up from leaf pairs `pair_idx` (Q,):
        (Q, depth, 4) on the device."""
        sibs = self._subtree_siblings(pair_idx) if self.dropped else []
        idx = pair_idx >> self.dropped
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
