"""The fused sumcheck (`sumcheck/fused.py`) on a CPU session, where it runs
the per-round prover (`sumcheck/prover.py`), against that prover and the
frozen JAX sumcheck proof of tests/torch_reference.json. Exact: messages,
challenges, final evaluations and the sponge state after the proof. The
CUDA kernels' rounds above the tail are held against the same prover in
the `cuda` cases of tests/test_torch_kernels.py and in chip_smoke.py."""

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.fields import gf
from deepprove_tpu_torch.sumcheck import VirtualPolynomial, fused, prove, prover
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.transcript.session import DeviceTranscript

P = gf.P


def _vp(n: int, degree: int, coeffs_dev: bool, seed: int) -> VirtualPolynomial:
    """Three base MLEs and two extension ones; a product of `degree` factors,
    one of lower degree (the row of ones pads it) when degree > 1, and one
    linear product."""
    rng = np.random.default_rng(seed)
    vp = VirtualPolynomial.new(n)
    for _ in range(3):
        vp.add_mle(gf.from_u64(rng.integers(0, P, size=1 << n, dtype=np.uint64)))
    rows = rng.integers(0, P, size=(2, 2, 1 << n), dtype=np.uint64)
    vp.add_mle_rows(gf.GF2(gf.from_u64(rows[0]), gf.from_u64(rows[1])))
    factors = [[k % 5 for k in range(degree)], [4], [1, 3][: max(1, degree - 1)]]
    for i, f in enumerate(factors):
        vp.add_product((i + 2, 3 * i), f)
    if coeffs_dev:
        c = rng.integers(0, P, size=(2, len(factors)), dtype=np.uint64)
        vp.coeffs_dev = gf.GF2(gf.from_u64(c[0]), gf.from_u64(c[1]))
    return vp


def _both(vp, label=b"fused"):
    """(fused output, its session, per-round output, its session)."""
    dt_f = DeviceTranscript.from_host(BasicTranscript(label), "cpu")
    dt_p = DeviceTranscript.from_host(BasicTranscript(label), "cpu")
    return fused.prove_device(vp, dt_f), dt_f, prover.prove_device(vp, dt_p), dt_p


def _equal(a: gf.GF2, b: gf.GF2) -> bool:
    return a.shape == b.shape and torch.equal(a.a0, b.a0) and torch.equal(a.a1, b.a1)


@pytest.mark.parametrize("coeffs_dev", [False, True])
@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n", [0, 1, 3, 7])
def test_fused_equals_per_round_prover(n, degree, coeffs_dev):
    vp = _vp(n, degree, coeffs_dev=coeffs_dev, seed=10 * n + degree)
    out, dt_f, want, dt_p = _both(vp)
    assert _equal(out.proof.round_messages, want.proof.round_messages)
    assert _equal(out.proof.point, want.proof.point)
    assert _equal(out.final_evals, want.final_evals)
    assert out.proof.round_messages.shape == (n, degree + 1)
    assert torch.equal(dt_f.state, dt_p.state)


def test_fused_equals_the_frozen_jax_sumcheck():
    a, b, (c0, c1) = R.sumcheck_inputs()
    vp = VirtualPolynomial.new(R.SUMCHECK_NUM_VARS)
    vp.add_mle(gf.from_u64(a))
    vp.add_mle(gf.from_u64(b))
    vp.add_mle(gf.GF2(gf.from_u64(c0), gf.from_u64(c1)))
    for coeff, factors in R.SUMCHECK_PRODUCTS:
        vp.add_product(coeff, factors)
    t = BasicTranscript(R.SUMCHECK_LABEL)
    o = prove(vp, t)  # the package's prove: the fused path
    assert R.plain({"proof": o.proof, "final_evals": o.final_evals}) == R.load()["sumcheck"]
    # the host transcript was advanced as the per-round prover advances it
    t2 = BasicTranscript(R.SUMCHECK_LABEL)
    prover.prove(vp, t2)
    assert t.read_challenge() == t2.read_challenge()


def test_factor_index_pads_with_the_constant_one():
    vp = _vp(2, 4, coeffs_dev=False, seed=1)
    idx = fused.factor_index(vp, 4, "cpu")
    assert idx.dtype == torch.int32
    assert idx.tolist() == [[0, 1, 2, 3], [4, -1, -1, -1], [1, 3, -1, -1]]


def test_cuda_wrappers_refuse_cpu_tensors_and_large_degrees():
    vp = _vp(3, 2, coeffs_dev=True, seed=2)
    dt = DeviceTranscript.from_host(BasicTranscript(b"x"), "cpu")
    with pytest.raises(ValueError):
        fused.prove_rounds_cuda(vp, dt, 3, 2)
    with pytest.raises(ValueError):
        fused._check(6, torch.device("cuda"))


@pytest.mark.parametrize("degree", [0, 6])
def test_tail_config_refuses_degrees_the_kernels_do_not_take(degree):
    """The tail's grid query refuses a degree before it reaches the library."""
    with pytest.raises(ValueError):
        fused.tail_config(degree)
