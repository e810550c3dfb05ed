"""The Merkle-compression wrapper and its CUDA kernel
(deepprove_tpu_torch/hashing/poseidon2_cuda.py, csrc/poseidon2_compress.cu).

This file imports neither jax nor the JAX package, so that its CUDA cases
run on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch

from deepprove_tpu_torch.fields import gf
from deepprove_tpu_torch.hashing import poseidon2_cuda


def _level(seed, m, device="cpu"):
    rng = np.random.default_rng(seed)
    return gf.from_u64(rng.integers(0, gf.P, size=(4, 2 * m), dtype=np.uint64), device)


@pytest.mark.parametrize(
    "bad",
    [
        torch.zeros((4, 3), dtype=torch.int64),
        torch.zeros((4, 0), dtype=torch.int64),
        torch.zeros((3, 4), dtype=torch.int64),
        torch.zeros((4, 4), dtype=torch.int32),
    ],
    ids=["odd-width", "empty", "three-planes", "int32"],
)
def test_compress_level_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((ValueError, TypeError)):
        poseidon2_cuda.compress_level(bad)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        poseidon2_cuda.compress_level_cuda(torch.zeros((4, 4), dtype=torch.int64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 1000, (1 << 17) + 5])
def test_cuda_kernel_matches_plain(cuda_device, m):
    level = _level(17, m, cuda_device)
    before = poseidon2_cuda.LAUNCHES
    got = poseidon2_cuda.compress_level(level)
    assert poseidon2_cuda.LAUNCHES == before + 1
    assert torch.equal(got, poseidon2_cuda.compress_level_plain(level))


def test_cpu_tensor_takes_the_plain_version():
    level = _level(18, 5)
    before = poseidon2_cuda.LAUNCHES
    got = poseidon2_cuda.compress_level(level)
    assert poseidon2_cuda.LAUNCHES == before
    assert torch.equal(got, poseidon2_cuda.compress_level_plain(level))


@pytest.mark.cuda
def test_cuda_tree_root_matches_cpu_tree(cuda_device):
    from deepprove_tpu_torch.pcs.merkle import MerkleTree

    leaves = np.random.default_rng(19).integers(0, gf.P, size=1 << 10, dtype=np.uint64)
    cpu = MerkleTree.from_leaves(gf.from_u64(leaves)).root
    assert MerkleTree.from_leaves(gf.from_u64(leaves, cuda_device)).root == cpu
