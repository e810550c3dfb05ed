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


@pytest.mark.parametrize("degree", [0, 6])
def test_round_config_refuses_degrees_the_kernels_do_not_take(degree):
    """The round kernel's grid query refuses a degree before it reaches the library."""
    with pytest.raises(ValueError):
        fused.round_config(degree, 63, 126)


def _round_shapes():
    """name -> (num_vars, each row's log-length, the products' factor lists,
    degree): the ragged kernel cases and the GPT-2-124M batch opening's rows
    (an eq and a merged row a claim, R.GPT2_OPENING_CLAIMS)."""
    shapes = {name: (n, rv, products, degree)
              for name, (n, _, products, degree, _, rv) in R.SUMCHECK_RAGGED_CASES.items()}
    rv = [lg for lg, claims in sorted(R.GPT2_OPENING_CLAIMS.items(), reverse=True) for _ in range(2 * claims)]
    shapes["gpt2_opening"] = (max(rv), rv, [[2 * c, 2 * c + 1] for c in range(len(rv) // 2)], 2)
    return shapes


@pytest.mark.parametrize("case", list(_round_shapes()))
def test_round_schedule_covers_each_rows_own_entries_once(case):
    """The round kernel's schedule, by arithmetic on its units (item i
    takes j = 0 .. span_i - 1 of every round): each product is one item
    whose span is its longest factor's pairs after the round's fold, so
    each of its own pairs is visited once; each row's folded entries have
    one writer, whose units cover them once; the round's units are the
    rows' own pairs (for the opening, half of them: two rows a claim), far
    below the rows times the longest row's pairs."""
    n, row_vars, factors, degree = _round_shapes()[case]
    plan = fused.round_plan(row_vars, factors, degree)
    products = [w[0] for w in plan.words if w[0] >= 0]
    assert products == list(range(len(factors)))
    writers = {}
    for i, w in enumerate(plan.words):
        assert len(w) == degree + 1
        for slot in w[1:]:
            if slot >= 0 and slot & fused.WRITES:
                writers.setdefault(slot & (fused.WRITES - 1), []).append(i)
    # one writing slot a row, every row (those no product lists too)
    assert sorted(writers) == list(range(len(row_vars))) and all(len(v) == 1 for v in writers.values())
    for rnd in range(n):
        bases = plan.bases(rnd)
        spans = [b - a for a, b in zip(bases, bases[1:])]
        assert bases[0] == 0 and min(spans) >= 0
        own = [fused._pairs(max(lg - rnd, 0)) for lg in row_vars]  # each row's pairs after the fold
        for p, f in enumerate(factors):
            assert spans[p] == max(own[r] for r in f)  # (p, j) for each own pair j, once
            assert (1 << (n - rnd - 1)) % spans[p] == 0  # the coefficient's scale is a whole power of two
        if rnd:  # a folding round: the writer's units j < own[r] write entries 2j, 2j + 1 (or the one entry)
            entries = [1 << max(lg - rnd, 0) for lg in row_vars]
            for r, (i,) in writers.items():
                assert spans[i] >= own[r]
                assert (2 * own[r] if entries[r] > 1 else 1) == entries[r]
        alone = [own[r] for r, (i,) in writers.items() if plan.words[i][0] < 0]
        assert bases[-1] == sum(max(own[r] for r in f) for f in factors) + (sum(alone) if rnd else 0)
        if case == "gpt2_opening" and rnd < n - fused.TAIL_LOG:  # the rounds the round kernel runs
            assert 2 * bases[-1] == sum(own)
            assert bases[-1] * 100 < len(row_vars) * (1 << (n - rnd - 1))
