"""The CUDA kernels' wrappers: the Merkle compression
(deepprove_tpu_torch/hashing/poseidon2_cuda.py, csrc/poseidon2_compress.cu),
the sponge (transcript/device.py, csrc/transcript.cu) and the sumcheck
rounds (sumcheck/fused.py, csrc/sumcheck.cu).

This file imports neither jax nor the JAX package, so that its CUDA cases
run on a GPU machine without JAX:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda
"""

import numpy as np
import pytest
import torch
import torch_reference as R

from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.hashing import poseidon2_cuda

EDGE = np.array(host.EDGE_VALUES, dtype=np.uint64)


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


def test_kernel_library_is_one_unit_over_every_source():
    """csrc/kernels.cu includes every other CUDA source, and the build's
    inputs (the key of its cached library) are every file of csrc/."""
    import os

    from deepprove_tpu_torch import kernels

    files = sorted(os.listdir(kernels.CSRC))
    assert sorted(os.path.basename(p) for p in kernels.INPUTS) == files
    with open(kernels.SOURCE) as f:
        unit = f.read()
    for name in files:
        if name.endswith(".cu") and name != "kernels.cu":
            assert f'#include "{name}"' in unit


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        poseidon2_cuda.compress_level_cuda(torch.zeros((4, 4), dtype=torch.int64))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


# (kind, size): a size is pairs, or ("block", k) = the kernel's block size + k
_CASES = (
    [("random", m) for m in (1, 3, 31, 32, 33, 1000, (1 << 17) + 5, 1 << 19)]
    + [("random", ("block", k)) for k in (-1, 0, 1)]
    + [(("edge", i), 33) for i in range(len(host.EDGE_VALUES))]
    + [("edge_mix", ("block", 1)), ("edge_mix", (1 << 17) + 5)]
)


def _case_level(kind, size, device):
    m = size if isinstance(size, int) else poseidon2_cuda.launch_config()[0] + size[1]
    if kind == "random":
        return _level(17, m, device)
    if kind == "edge_mix":
        return gf.from_u64(np.random.default_rng(18).choice(EDGE, size=(4, 2 * m)), device)
    return gf.from_u64(np.full((4, 2 * m), EDGE[kind[1]], dtype=np.uint64), device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,size", _CASES, ids=[f"{k}-{s}" for k, s in _CASES])
def test_cuda_kernel_matches_plain(cuda_device, kind, size):
    level = _case_level(kind, size, cuda_device)
    before = poseidon2_cuda.LAUNCHES
    got = poseidon2_cuda.compress_level(level)
    assert poseidon2_cuda.LAUNCHES == before + 1
    assert torch.equal(got, poseidon2_cuda.compress_level_plain(level))


@pytest.mark.cuda
def test_cuda_field_arithmetic_matches_python_ints(cuda_device):
    """The kernel's lazy field arithmetic on operands in [p, 2^64)."""
    rng = np.random.default_rng(20)
    top = np.array([gf.P, gf.P + 1, 2**64 - 2**32, 2**64 - 2, 2**64 - 1], dtype=np.uint64)
    a, b, c = (
        np.concatenate([rng.integers(gf.P, 2**64 - 1, size=1024, dtype=np.uint64, endpoint=True),
                        rng.choice(np.concatenate([top, EDGE]), size=256)])
        for _ in range(3)
    )
    got = poseidon2_cuda.goldilocks_probe(*(gf.from_u64(x, cuda_device) for x in (a, b, c)))
    np.testing.assert_array_equal(gf.to_u64(got), R.goldilocks_probe_plain(a, b, c))


def test_goldilocks_probe_plain_is_the_field_arithmetic():
    """The CUDA probe's Python-int oracle on the largest u64 operands."""
    m = np.array([2**64 - 1], dtype=np.uint64)
    p = np.array([gf.P], dtype=np.uint64)
    rows = R.goldilocks_probe_plain(m, p, p + np.uint64(5))
    lo = 2**64 - 1 - gf.P  # 2^64 - 1 = 2^32 - 2 (mod p)
    assert rows[:, 0].tolist() == [0, 5, lo + 5, 7 * (lo + 5)]


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


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 3, 5, 7, 16, 33])
def test_cuda_sponge_matches_plain(cuda_device, k):
    from deepprove_tpu_torch.transcript import device as devt
    from deepprove_tpu_torch.transcript.session import label_chunks

    rng = np.random.default_rng(30 + k)
    cpu = torch.from_numpy(rng.integers(0, gf.P, size=devt.STATE_WORDS, dtype=np.uint64).view(np.int64))
    cpu[8:12], cpu[12], cpu[17] = 0, 0, 0
    dev = cpu.to(cuda_device)
    arr = rng.integers(0, gf.P, size=(2, k + 2), dtype=np.uint64)
    ext = gf.GF2(gf.from_u64(arr[0]), gf.from_u64(arr[1]))
    label = (tuple(label_chunks(b"a label longer than the rate")),)
    before = devt.LAUNCHES
    got = devt.sponge(dev, pre=[k, 3], arr=gf.GF2(ext.a0.to(cuda_device), ext.a1.to(cuda_device)),
                      labels=label, k=k)
    assert devt.LAUNCHES == before + 1
    want = devt.sponge_plain(cpu, pre=[k, 3], arr=ext, labels=label, k=k)
    assert torch.equal(got.a0.cpu(), want.a0) and torch.equal(got.a1.cpu(), want.a1)
    assert torch.equal(dev.cpu(), cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("tail_log", [10, 3])
@pytest.mark.parametrize("degree", [1, 2, 3, 5])
def test_cuda_fused_sumcheck_matches_plain(cuda_device, monkeypatch, degree, tail_log):
    from deepprove_tpu_torch.sumcheck import VirtualPolynomial, fused, prover
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    monkeypatch.setattr(fused, "TAIL_LOG", tail_log)
    n, rng = 7, np.random.default_rng(40 + degree)
    vp = VirtualPolynomial.new(n)
    rows = rng.integers(0, gf.P, size=(2, 5, 1 << n), dtype=np.uint64)
    vp.add_mle_rows(gf.GF2(gf.from_u64(rows[0], cuda_device), gf.from_u64(rows[1], cuda_device)))
    vp.add_product((3, 1), list(range(degree)))
    vp.add_product((1, 0), [4])  # lower degree: padded with the constant 1
    before = dict(fused.LAUNCHES)
    dt = DeviceTranscript.from_host(BasicTranscript(b"k"), cuda_device)
    out = fused.prove_device(vp, dt)
    above = max(0, n - tail_log)
    assert fused.LAUNCHES["sumcheck_round"] - before["sumcheck_round"] == above
    assert fused.LAUNCHES["sumcheck_finish"] - before["sumcheck_finish"] == above
    assert fused.LAUNCHES["sumcheck_tail"] - before["sumcheck_tail"] == 1
    dt_plain = DeviceTranscript.from_host(BasicTranscript(b"k"), "cpu")
    want = prover.prove_device(vp, dt_plain)  # torch on the card, the sponge on the CPU
    pairs = ((out.proof.round_messages, want.proof.round_messages), (out.proof.point, want.proof.point),
             (out.final_evals, want.final_evals))
    for got, want in pairs:
        assert torch.equal(got.a0.cpu(), want.a0.cpu()) and torch.equal(got.a1.cpu(), want.a1.cpu())
    assert torch.equal(dt.state.cpu(), dt_plain.state)
