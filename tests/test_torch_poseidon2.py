"""The port's Poseidon2 (plain torch `permute_planes`, the level
compression wrapper, the native host permutation) against the JAX package's `permute_host`, `compress_host` and
`merkle._compress_level_scan`, and the golden vectors. Exact."""

import json
import os

import numpy as np
import pytest
import torch

from deepprove_tpu.fields import gf as jgf
from deepprove_tpu.hashing import poseidon2 as jp2
from deepprove_tpu.pcs import merkle as jmerkle
from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.hashing import poseidon2, poseidon2_cuda
from deepprove_tpu_torch.pcs import merkle
from deepprove_tpu_torch.pcs.merkle import MerkleTree

P = gf.P
VECS = json.load(open(os.path.join(os.path.dirname(__file__), "golden_vectors.json")))


def _rand(seed, shape):
    return np.random.default_rng(seed).integers(0, P, size=shape, dtype=np.uint64)


def test_permute_planes_matches_permute_host():
    states = _rand(11, (64, 8))
    got = poseidon2.permute_planes([gf.from_u64(states[:, i]) for i in range(8)])
    got = np.stack([gf.to_u64(p) for p in got], axis=-1)
    np.testing.assert_array_equal(got, jp2.permute_host(states))


def test_native_host_permutation_matches_jax_host():
    states = _rand(12, (16, 8))
    np.testing.assert_array_equal(poseidon2.permute_host(states), jp2.permute_host(states))
    l, r = _rand(13, (16, 4)), _rand(14, (16, 4))
    np.testing.assert_array_equal(poseidon2.compress_host(l, r), jp2.compress_host(l, r))


def test_compress_level_plain_matches_compress_host():
    level = _rand(15, (4, 2 * 64))
    got = gf.to_u64(poseidon2_cuda.compress_level_plain(gf.from_u64(level)))
    want = jp2.compress_host(level[:, 0::2].T, level[:, 1::2].T).T
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("edge", list(range(len(host.EDGE_VALUES))) + ["mix"])
def test_compress_level_plain_matches_compress_host_on_edge_values(edge):
    """Levels of the values at the u64 form's carry and reduction boundaries,
    the inputs a hand-written kernel's arithmetic gets wrong first."""
    values = np.array(host.EDGE_VALUES, dtype=np.uint64)
    if edge == "mix":
        level = np.random.default_rng(21).choice(values, size=(4, 2 * 64))
    else:
        level = np.full((4, 2 * 8), values[edge], dtype=np.uint64)
    got = gf.to_u64(poseidon2_cuda.compress_level_plain(gf.from_u64(level)))
    want = jp2.compress_host(level[:, 0::2].T, level[:, 1::2].T).T
    np.testing.assert_array_equal(got, want)


def test_compress_level_matches_jax_scan():
    level = _rand(16, (4, 2 * 64))
    got = gf.to_u64(poseidon2_cuda.compress_level(gf.from_u64(level)))
    want = jgf.to_u64(jmerkle._compress_level_scan(jgf.from_u64(level)))
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_and_compress_host(cuda_device):
    level = _rand(17, (4, 2 * 64))
    got = poseidon2_cuda.compress_level(gf.from_u64(level, cuda_device))
    assert torch.equal(got.cpu(), poseidon2_cuda.compress_level_plain(gf.from_u64(level)))
    want = jp2.compress_host(level[:, 0::2].T, level[:, 1::2].T).T
    np.testing.assert_array_equal(gf.to_u64(got), want)


def test_permutation_golden():
    planes = poseidon2.permute_planes([gf.from_u64(np.array([i], dtype=np.uint64)) for i in range(8)])
    assert [int(gf.to_u64(p)[0]) for p in planes] == VECS["poseidon2_perm_0to7"]
    assert poseidon2.permute_host(np.arange(8, dtype=np.uint64)).tolist() == VECS["poseidon2_perm_0to7"]


def test_merkle_root_golden():
    tree = MerkleTree.from_leaves(gf.from_u64(np.arange(16, dtype=np.uint64)))
    assert list(tree.root) == VECS["merkle_root_0to15"]


@pytest.mark.parametrize("n", [1, 2, 16])
def test_trees_built_side_by_side_equal_trees_built_alone(n):
    leaves = [gf.from_u64(_rand(60 + i, n)) for i in range(3)]
    if n > 1:  # extension leaves come in pairs
        leaves.append(gf.GF2(gf.from_u64(_rand(63, n)), gf.from_u64(_rand(64, n))))
    leaves.append(gf.from_u64(_rand(65, 2 * n)))  # another length: a group of its own
    together = MerkleTree.from_leaves_many(leaves)
    for tree, lv in zip(together, leaves, strict=True):
        alone = MerkleTree(leaves=lv, levels=[merkle.leaf_digests(lv)])
        while alone.levels[-1].shape[1] > 1:
            alone.levels.append(poseidon2_cuda.compress_level_plain(alone.levels[-1]))
        assert tree.root == alone.root
        assert [lvl.tolist() for lvl in tree.levels] == [lvl.tolist() for lvl in alone.levels]
