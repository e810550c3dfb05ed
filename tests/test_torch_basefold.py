"""The port's NTT and Basefold PCS against naive transforms and the JAX
package's commit/open at 2^6 evals (RS path) and 2^2 evals (trivial
commitment), num_queries=11, basecode 2^2, frozen in torch_reference.json
(made and checked against the JAX package by make_torch_reference.py and
test_torch_reference.py). Exact."""

import copy

import numpy as np
import pytest

import torch_reference as R
from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.pcs import basefold, ntt
from deepprove_tpu_torch.transcript import BasicTranscript

P = gf.P


def _naive_eval(coeffs, x):
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + int(c)) % P
    return acc


def test_fft_and_coset_fft_match_naive():
    rng = np.random.default_rng(31)
    lg_n = 4
    coeffs = rng.integers(0, P, size=1 << lg_n, dtype=np.uint64)
    w = int(host.pow_const(np.uint64(host.TWO_ADIC_GENERATOR), 1 << (host.TWO_ADICITY - lg_n)))
    got = gf.to_u64(ntt.fft(gf.from_u64(coeffs))).tolist()
    assert got == [_naive_eval(coeffs, pow(w, i, P)) for i in range(1 << lg_n)]
    s = host.MULTIPLICATIVE_GENERATOR
    got = gf.to_u64(ntt.coset_fft(gf.from_u64(coeffs), s)).tolist()
    assert got == [_naive_eval(coeffs, s * pow(w, i, P) % P) for i in range(1 << lg_n)]


def test_interpolate_over_hypercube_gives_multilinear_coeffs():
    rng = np.random.default_rng(32)
    evals = rng.integers(0, P, size=8, dtype=np.uint64)
    c = gf.to_u64(ntt.interpolate_over_hypercube(gf.from_u64(evals))).tolist()
    for b in range(8):
        x = [(b >> i) & 1 for i in range(3)]
        val = sum(c[m] for m in range(8) if all(x[i] for i in range(3) if (m >> i) & 1)) % P
        assert val == int(evals[b])


def _commit_and_open(name):
    big, big_pt, small, small_pt = R.basefold_inputs()
    evals, pt = (big, big_pt) if name == "rs" else (small, small_pt)
    params = basefold.setup(R.BASEFOLD_MAX_LOG, **R.BASEFOLD_KW)
    comm = basefold.commit(params, gf.from_u64(evals))
    proof = basefold.open(params, comm, pt, BasicTranscript(R.BASEFOLD_LABEL))
    return params, comm, proof, evals, pt


@pytest.fixture(scope="module", params=["rs", "trivial"])
def opened(request):
    return request.param, _commit_and_open(request.param)


def test_commit_and_open_match_jax(opened):
    name, (_, comm, proof, _, _) = opened
    ref = R.load()["basefold"][name]
    assert list(comm.commitment.root) == ref["root"]
    assert R.plain(proof) == ref["proof"]


def test_verify_accepts(opened):
    _, (params, comm, proof, evals, pt) = opened
    basefold.verify(
        params, comm.commitment, pt, host.mle_eval_v(evals, pt), proof,
        BasicTranscript(R.BASEFOLD_LABEL), device="cpu",
    )


def _flip(proof, name):
    bad = copy.deepcopy(proof)
    if name == "trivial":
        bad.trivial_evals[0][1] = (bad.trivial_evals[0][1] + 1) % P
    else:
        q = bad.queries[3]
        lo, hi = q.oracle_pairs[0]
        q.oracle_pairs[0] = (lo, ((hi[0] + 1) % P, hi[1]))
    return bad


def test_verify_rejects_a_flipped_element(opened):
    name, (params, comm, proof, evals, pt) = opened
    with pytest.raises(AssertionError):
        basefold.verify(
            params, comm.commitment, pt, host.mle_eval_v(evals, pt), _flip(proof, name),
            BasicTranscript(R.BASEFOLD_LABEL), device="cpu",
        )


def test_batch_open_roundtrip_and_rejection():
    """Three polys of two sizes, two of them opened at one point."""
    rng = np.random.default_rng(33)
    params = basefold.setup(5, num_queries=7, basecode_msg_size_log=2)
    evals = [rng.integers(0, P, size=n, dtype=np.uint64) for n in (32, 32, 16)]
    comms = [basefold.commit(params, gf.from_u64(e)) for e in evals]
    pts = [
        [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64)) for _ in range(n)]
        for n in (5, 4)
    ]
    point_of = [0, 0, 1]
    batch = [
        basefold.BatchEvaluation(poly=i, point=point_of[i], value=host.mle_eval_v(e, pts[point_of[i]]))
        for i, e in enumerate(evals)
    ]
    proof = basefold.batch_open(
        params, [gf.from_u64(e) for e in evals], comms, pts, batch, BasicTranscript(b"bo")
    )
    cms = [c.commitment for c in comms]
    basefold.batch_verify(params, cms, pts, batch, proof, BasicTranscript(b"bo"), device="cpu")
    bad = copy.deepcopy(batch)
    bad[2].value = ((bad[2].value[0] + 1) % P, bad[2].value[1])
    with pytest.raises(AssertionError):
        basefold.batch_verify(params, cms, pts, bad, proof, BasicTranscript(b"bo"), device="cpu")


def test_commit_many_equals_commit_one_at_a_time():
    rng = np.random.default_rng(34)
    params = basefold.setup(5, num_queries=7, basecode_msg_size_log=2)
    evals = [gf.from_u64(rng.integers(0, P, size=n, dtype=np.uint64)) for n in (32, 4, 32, 16, 4)]
    many = basefold.commit_many(params, evals)
    for got, e in zip(many, evals, strict=True):
        one = basefold.commit(params, e)
        assert got.commitment == one.commitment
        assert gf.to_u64(got.codeword).tolist() == gf.to_u64(one.codeword).tolist()
    assert [c.commitment.is_trivial for c in many] == [False, True, False, False, True]


def test_witness_commit_roots_stay_on_the_device_until_materialized():
    """`host_roots=False` reads nothing: each root is a deferred device
    value, and materializing a structure that holds the commitments gives
    the roots that `commit_many` reads at once."""
    from deepprove_tpu_torch import glue

    rng = np.random.default_rng(35)
    params = basefold.setup(5, num_queries=7, basecode_msg_size_log=2)
    evals = [gf.from_u64(rng.integers(0, P, size=n, dtype=np.uint64)) for n in (32, 4, 16)]
    want = [c.commitment for c in basefold.commit_many(params, evals)]
    got = [c.commitment for c in basefold.commit_many(params, evals, host_roots=False)]
    assert all(isinstance(c.root, glue.Deferred) for c in got)
    assert glue.materialize({"commits": got})["commits"] == want
    assert all(isinstance(c.root, tuple) and len(c.root) == 4 for c in got)
