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


# sponge calls from one entry state: (challenges, array elements, base
# array?, labels); several labels take one challenge each. The kernel reads
# the array 32 words at a time: arrays of 16, 17 and 33 extension elements
# (32, 34, 66 words) and 32 and 33 base words reach and cross that batch.
_SPONGE_CALLS = [(k, a, False, lab) for k in (0, 1, 2, 5, 33) for a in (0, 1, 5) for lab in ("none", "one")]
_SPONGE_CALLS += [(k, 5, True, lab) for k in (0, 1, 2, 5, 33) for lab in ("none", "one")]
_SPONGE_CALLS += [(3, a, base, "several") for a, base in ((0, False), (1, False), (5, False), (5, True))]
_SPONGE_CALLS += [(k, a, False, lab) for k, lab in ((1, "none"), (33, "one"), (3, "several")) for a in (16, 17, 33)]
_SPONGE_CALLS += [(k, a, True, "one") for k in (0, 5) for a in (32, 33)]


@pytest.mark.cuda
@pytest.mark.parametrize("olen", range(5))
@pytest.mark.parametrize("ilen", range(4))
def test_cuda_sponge_matches_plain(cuda_device, ilen, olen):
    """Entry states of every input and output count; calls of 0-33
    challenges, arrays of 0, 1, 5, 16, 17 and 33 extension elements and of
    5, 32 and 33 base ones, no, one and several labels: challenges and the
    final state bit for bit."""
    from deepprove_tpu_torch.transcript import device as devt
    from deepprove_tpu_torch.transcript.session import label_chunks

    rng = np.random.default_rng(30 + 5 * ilen + olen)
    entry = torch.from_numpy(rng.integers(0, gf.P, size=devt.STATE_WORDS, dtype=np.uint64).view(np.int64))
    entry[8 + ilen : 12], entry[12], entry[17] = 0, ilen, olen
    labels = {"none": (), "one": (tuple(label_chunks(b"a label longer than the rate")),),
              "several": tuple(tuple(label_chunks(lbl)) for lbl in (b"alpha", b"beta", b"a longer third label"))}
    for k, size, base, lab in _SPONGE_CALLS:
        vals = rng.integers(0, gf.P, size=(2, size), dtype=np.uint64)
        arr = gf.from_u64(vals[0]) if base else gf.GF2(gf.from_u64(vals[0]), gf.from_u64(vals[1]))
        arr_dev = arr.to(cuda_device) if base else gf.GF2(arr.a0.to(cuda_device), arr.a1.to(cuda_device))
        cpu, dev = entry.clone(), entry.to(cuda_device)
        before = devt.LAUNCHES
        got = devt.sponge(dev, pre=[k, 3], arr=arr_dev, labels=labels[lab], k=k)
        assert devt.LAUNCHES == before + 1
        want = devt.sponge_plain(cpu, pre=[k, 3], arr=arr, labels=labels[lab], k=k)
        case = (k, size, base, lab)
        assert torch.equal(got.a0.cpu(), want.a0) and torch.equal(got.a1.cpu(), want.a1), case
        assert torch.equal(dev.cpu(), cpu), case


@pytest.mark.cuda
def test_cuda_permutation_matches_host_on_random_states(cuda_device):
    """The warp permutation, reached through sponge_kernel (a state with
    nothing queued and no output permutes once on its first squeeze),
    against the host permutation on 128 random states, the edge values and
    random mixes of them: the challenge and every state word bit for bit."""
    from deepprove_tpu_torch.transcript import device as devt

    rng = np.random.default_rng(50)
    states = [rng.integers(0, gf.P, size=8, dtype=np.uint64) for _ in range(128)]
    states += [np.full(8, v, dtype=np.uint64) for v in EDGE] + [rng.choice(EDGE, size=8) for _ in range(16)]
    for words in states:
        cpu = torch.zeros(devt.STATE_WORDS, dtype=torch.int64)
        cpu[:8] = torch.from_numpy(words.view(np.int64))
        dev = cpu.to(cuda_device)
        before = devt.LAUNCHES
        got = devt.sponge(dev, k=1)
        assert devt.LAUNCHES == before + 1
        want = devt.sponge_plain(cpu, k=1)
        assert torch.equal(got.a0.cpu(), want.a0) and torch.equal(got.a1.cpu(), want.a1), words
        assert torch.equal(dev.cpu(), cpu), words


# (num_vars, rows, products, degree, tail start): five rows at 7 variables
# for each degree, with the tail from round 0 and from round 4; rows of 2^19
# with the tail from 10, whose first finish sums 1024 partials (more than
# the kernel's threads, at the main path's degree 2 and the maxpool's 5);
# LayerNorm's two sumchecks; then the edge shapes of torch_reference.SUMCHECK_EDGE_CASES
# and its rows of their own lengths (SUMCHECK_RAGGED_CASES, a sixth entry)
_SUMCHECK_CASES = {
    f"n7_degree_{d}_tail_{t}": (7, 5, [list(range(d)), [4]], d, t) for t in (10, 3) for d in range(1, 6)
}
_SUMCHECK_CASES["n19_two_rows_degree_2_tail_10"] = (19, 2, [[0, 1], [1]], 2, 10)
_SUMCHECK_CASES["n19_one_row_degree_5_tail_10"] = (19, 1, [[0, 0, 0, 0, 0], [0]], 5, 10)
# LayerNorm's io sumcheck (degree 4) and its linking sumcheck, whose
# products list one row twice, with two rounds above the tail
_SUMCHECK_CASES["layernorm_io_n12_tail_10"] = (12, 6, [[0, 1, 2, 3], [0, 1, 4, 3], [0, 5]], 4, 10)
_SUMCHECK_CASES["layernorm_link_n12_tail_10"] = (12, 3, [[0, 1, 1], [0, 2, 2]], 3, 10)
_SUMCHECK_CASES.update(R.SUMCHECK_EDGE_CASES)
_SUMCHECK_CASES.update(R.SUMCHECK_RAGGED_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(_SUMCHECK_CASES))
def test_cuda_fused_sumcheck_matches_plain(cuda_device, monkeypatch, case):
    from deepprove_tpu_torch.sumcheck import VirtualPolynomial, fused, prover
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    n, m, products, degree, tail_log, *row_vars = _SUMCHECK_CASES[case]
    row_vars = row_vars[0] if row_vars else [n] * m
    # the case is well formed: its products index its rows and reach its degree
    assert max(len(f) for f in products) == degree and all(0 <= r < m for f in products for r in f)
    if tail_log is not None:
        monkeypatch.setattr(fused, "TAIL_LOG", tail_log)
    rng = np.random.default_rng(40 + len(case) + degree)
    vp = VirtualPolynomial.new(n)
    for lg in row_vars:
        row = rng.integers(0, gf.P, size=(2, 1 << lg), dtype=np.uint64)
        vp.add_mle(gf.GF2(gf.from_u64(row[0], cuda_device), gf.from_u64(row[1], cuda_device)))
    for f in products:  # host-pair coefficients
        vp.add_product(tuple(int(v) for v in rng.integers(0, gf.P, size=2, dtype=np.uint64)), f)
    before = dict(fused.LAUNCHES)
    dt = DeviceTranscript.from_host(BasicTranscript(b"k"), cuda_device)
    out = fused.prove_device(vp, dt)
    above = max(0, n - fused.TAIL_LOG)
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


@pytest.mark.cuda
def test_cuda_tail_runs_on_every_sm(cuda_device):
    """The tail is one cooperative grid with the same blocks on every SM."""
    from deepprove_tpu_torch.sumcheck import fused

    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for degree in range(1, fused.MAX_DEGREE + 1):
        cfg = fused.tail_config(degree)
        assert cfg["blocks_per_sm"] >= 1 and cfg["blocks"] == sms * cfg["blocks_per_sm"], cfg
