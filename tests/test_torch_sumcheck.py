"""The port's transcript, MLE and sumcheck against the golden vectors and
the JAX package's sumcheck proof on the same VirtualPolynomial, computed
live by `make_torch_reference.sumcheck_reference`. Exact."""

import json
import os

import numpy as np
import pytest

import make_torch_reference as M
import torch_reference as R
from deepprove_tpu_torch import glue
from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.poly import mle
from deepprove_tpu_torch.sumcheck import VirtualPolynomial, prove, verify
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.transcript.session import DeviceTranscript

P = gf.P
VECS = json.load(open(os.path.join(os.path.dirname(__file__), "golden_vectors.json")))


def test_transcript_golden():
    t = BasicTranscript(b"m2vec")
    for v in (1, 2, 3):
        t.append_field_element(v)
    c1 = t.get_and_append_challenge(b"golden")
    c2 = t.read_challenge()
    assert [list(c1), list(c2)] == VECS["transcript_m2vec_123"]


def test_session_transcript_matches_host_transcript():
    rng = np.random.default_rng(21)
    base = rng.integers(0, P, size=5, dtype=np.uint64)
    ext = rng.integers(0, P, size=(3, 2), dtype=np.uint64)
    host_t = BasicTranscript(b"m2vec")
    host_t.append_field_elements(base)
    host_t.append_field_element_exts([tuple(int(v) for v in e) for e in ext])
    want = [host_t.get_and_append_challenge(b"lbl") for _ in range(3)] + [host_t.read_challenge()]

    dt = DeviceTranscript.from_host(BasicTranscript(b"m2vec"), "cpu")
    dt.append_base(gf.from_u64(base))
    dt.append_exts(gf.ext_from_pairs([tuple(int(v) for v in e) for e in ext], "cpu"))
    got = gf.ext_to_pairs(dt.get_and_append_challenges(b"lbl", 3)) + gf.ext_to_pairs(
        dt.read_challenges(1)
    )
    assert got == want
    # absorbs and squeezes read nothing back; bringing a host transcript to
    # the session's state is one read
    assert dt.pulls == 0
    synced = BasicTranscript(b"other")
    dt.sync_to_host(synced)
    assert dt.pulls == 1
    assert synced.read_challenge() == host_t.read_challenge()


def test_sumcheck_golden():
    rng = np.random.default_rng(42)
    a = rng.integers(0, P, size=8, dtype=np.uint64)
    b = rng.integers(0, P, size=8, dtype=np.uint64)
    vp = VirtualPolynomial.new(3)
    vp.add_product((1, 0), [vp.add_mle(gf.from_u64(a)), vp.add_mle(gf.from_u64(b))])
    o = prove(vp, BasicTranscript(b"golden"))
    assert [[list(e) for e in r] for r in o.proof.round_messages] == VECS["sumcheck_seed42_msgs"]
    assert [list(p) for p in o.proof.point] == VECS["sumcheck_seed42_point"]


def _reference_vp():
    a, b, (c0, c1) = R.sumcheck_inputs()
    vp = VirtualPolynomial.new(R.SUMCHECK_NUM_VARS)
    vp.add_mle(gf.from_u64(a))
    vp.add_mle(gf.from_u64(b))
    vp.add_mle(gf.GF2(gf.from_u64(c0), gf.from_u64(c1)))
    for coeff, factors in R.SUMCHECK_PRODUCTS:
        vp.add_product(coeff, factors)
    return vp, (a, b, c0, c1)


def test_sumcheck_matches_jax_prover():
    vp, _ = _reference_vp()
    o = prove(vp, BasicTranscript(R.SUMCHECK_LABEL))
    assert R.plain({"proof": o.proof, "final_evals": o.final_evals}) == M.sumcheck_reference()


def _claimed_sum(a, b, c0, c1):
    total = (0, 0)
    for i in range(len(a)):
        c = (int(c0[i]), int(c1[i]))
        abc = host.ext_mul((int(a[i]) * int(b[i]) % P, 0), c)
        total = host.ext_add(total, host.ext_add(abc, host.ext_mul((3, 9), (int(b[i]), 0))))
    return total


def test_sumcheck_verifier_accepts_and_rejects():
    vp, (a, b, c0, c1) = _reference_vp()
    o = prove(vp, BasicTranscript(R.SUMCHECK_LABEL))
    claim = _claimed_sum(a, b, c0, c1)
    n, d = R.SUMCHECK_NUM_VARS, 3
    sub = verify(claim, o.proof.round_messages, n, d, BasicTranscript(R.SUMCHECK_LABEL))
    assert sub.point == o.proof.point
    f = o.final_evals
    want = host.ext_add(host.ext_mul(host.ext_mul(f[0], f[1]), f[2]), host.ext_mul((3, 9), f[1]))
    assert sub.expected_evaluation == want
    msgs = [list(m) for m in o.proof.round_messages]
    msgs[1][0] = ((msgs[1][0][0] + 1) % P, msgs[1][0][1])
    with pytest.raises(AssertionError):
        verify(claim, msgs, n, d, BasicTranscript(R.SUMCHECK_LABEL))


def test_mle_evaluate_fix_and_eq_match_host():
    rng = np.random.default_rng(22)
    vals = rng.integers(0, P, size=16, dtype=np.uint64)
    pairs = [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64)) for _ in range(4)]
    pt = gf.ext_from_pairs(pairs, "cpu")
    assert gf.ext_to_pairs(mle.evaluate(gf.from_u64(vals), pt)) == [host.mle_eval_v(vals, pairs)]
    # fixing the two high variables, then the two low ones, is evaluation
    high = mle.fix_high_variables(gf.from_u64(vals), pt[2:])
    assert gf.ext_to_pairs(mle.evaluate(high, pt[:2])) == [host.mle_eval_v(vals, pairs)]
    # <eq(., r), f> = f(r); the reversed table is the table of the reversed point
    eq = mle.eq_table(pt)
    inner = gf.ext_sum_axis(gf.ext_mul_base(eq, gf.from_u64(vals)), 0)
    assert gf.ext_to_pairs(inner) == [host.mle_eval_v(vals, pairs)]
    rev = mle.eq_table(gf.ext_from_pairs(pairs[::-1], "cpu"))
    assert gf.ext_to_pairs(mle.eq_table(pt, reverse=True)) == gf.ext_to_pairs(rev)


def test_materialize_lowers_device_leaves_to_host_ints():
    e = gf.ext_from_pairs([(1, 2), (3, 4)], "cpu")
    tree = {"claim": glue.DevClaim(point=e, eval=e[0]), "base": gf.from_u64([5, 6]),
            "grid": gf.ext_stack([e, e]), "np": glue.NpGF(gf.from_u64([[7]]))}
    out = glue.materialize(tree)
    assert out["claim"].point == [(1, 2), (3, 4)] and out["claim"].eval == (1, 2)
    assert out["base"] == [5, 6]
    assert out["grid"] == [[(1, 2), (3, 4)], [(1, 2), (3, 4)]]
    assert out["np"].dtype == np.uint64 and out["np"].tolist() == [[7]]
