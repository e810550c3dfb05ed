"""The port's logup-GKR and lookup context against the JAX package.

The logup proofs on the inputs of tests/test_logup.py (torch_reference.
logup_case, at fixed seeds) must equal the JAX package's, frozen in
torch_reference.json (checked against the JAX package by
test_torch_reference.py), and the port's verifier must accept them; a wrong
multiplicity must leave the lookup fractions unbalanced. The fraction tree
and the column merge are compared live with the JAX package at 2^4 (one
quick XLA compile each); the lookup tables, the table challenges, the
requant spec and the multiplicity counting with the JAX package's host
code. Tolerance: exact equality (field elements and integers).
"""

import copy

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch import glue
from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.lookup import logup
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.transcript.session import DeviceTranscript
from deepprove_tpu_torch.zkml import lookup_context as LC
from deepprove_tpu_torch.zkml import quantization as Q


def _cols(cs):
    return [gf.from_u64(c) for c in cs]


def _prove(p):
    if p["kind"] == "lookup":
        inp = logup.LogUpInput.new_lookup(_cols(p["columns"]), p["const"], p["sep"], p["cpi"])
        return logup.batch_prove(inp, BasicTranscript(p["label"]))
    if p["kind"] == "table":
        inp = logup.LogUpInput.new_table(_cols(p["columns"]), gf.from_u64(p["mult"]), p["const"], p["sep"])
        return logup.batch_prove(inp, BasicTranscript(p["label"]))
    dt = DeviceTranscript.from_host(BasicTranscript(p["label"]), "cpu")
    if p["kind"] == "grouped_lookups":
        proof = logup.batch_prove_grouped([(_cols(c), k, s) for c, k, s in p["instances"]], dt)
    else:
        proof = logup.batch_prove_grouped_tables(
            [(_cols(c), gf.from_u64(m), k, s) for c, m, k, s in p["instances"]], dt
        )
    return glue.materialize(proof)


def _verify(p, proof):
    t = BasicTranscript(p["label"])
    if p["kind"] == "lookup":
        n = len(p["columns"]) // p["cpi"]
        return logup.verify_logup_proof(proof, n, p["const"], p["sep"], t)
    if p["kind"] == "table":
        return logup.verify_logup_proof(proof, 1, p["const"], p["sep"], t)
    if p["kind"] == "grouped_lookups":
        specs = [(len(c), k, s) for c, k, s in p["instances"]]
        return logup.verify_logup_proof(proof, 0, (0, 0), (0, 0), t, instance_specs=specs)
    specs = [(len(c), k, s) for c, _, k, s in p["instances"]]
    return logup.verify_logup_proof(proof, 0, (0, 0), (0, 0), t, table_instance_specs=specs)


@pytest.fixture(scope="module")
def proofs():
    return {name: [_prove(p) for p in R.logup_case(name)] for name in R.LOGUP_CASES}


def _balance(claims):
    """Sum of every proof's fractions, as (numerator, denominator)."""
    num, den = (0, 0), (1, 0)
    for c in claims:
        for n, d in zip(c.numerators, c.denominators):
            num = host.ext_add(host.ext_mul(num, d), host.ext_mul(n, den))
            den = host.ext_mul(den, d)
    return num, den


@pytest.mark.parametrize("name", R.LOGUP_CASES)
def test_logup_proof_equals_jax_proof(proofs, name):
    assert [R.plain(p) for p in proofs[name]] == R.load()["logup"][name]


@pytest.mark.parametrize("name", R.LOGUP_CASES)
def test_logup_verifier_accepts_and_claims_are_the_column_mles(proofs, name):
    for p, proof in zip(R.logup_case(name), proofs[name]):
        out = _verify(p, proof)
        if p["kind"] == "lookup":
            mles = p["columns"]
        elif p["kind"] == "table":
            mles = [p["mult"]] + p["columns"]
        elif p["kind"] == "grouped_lookups":
            mles = [c for cols, _, _ in p["instances"] for c in cols]
        else:
            mles = [c for cols, m, _, _ in p["instances"] for c in [m] + cols]
        pt = out.claims[0].point
        assert [c.eval for c in out.claims] == [host.mle_eval_v(m, pt) for m in mles]
        assert all(c.point == pt for c in out.claims)


def test_table_lookups_balance_and_a_wrong_multiplicity_does_not(proofs):
    for name, balanced in (("table", True), ("wrong_multiplicity", False)):
        claims = [_verify(p, proof) for p, proof in zip(R.logup_case(name), proofs[name])]
        num, den = _balance(claims)
        assert (num == (0, 0)) == balanced
        assert den != (0, 0)


def test_logup_verifier_rejects_tampered_proofs(proofs):
    p, proof = R.logup_case("multi")[0], proofs["multi"][0]
    for tamper in ("circuit_output", "round_evaluation", "output_claim"):
        bad = copy.deepcopy(proof)
        if tamper == "circuit_output":
            bad.circuit_outputs[0][0] = host.ext_add(bad.circuit_outputs[0][0], (1, 0))
        elif tamper == "round_evaluation":
            bad.round_evaluations[-1][0] = host.ext_add(bad.round_evaluations[-1][0], (1, 0))
        else:
            bad.output_claims[1].eval = host.ext_add(bad.output_claims[1].eval, (1, 0))
        with pytest.raises(AssertionError):
            _verify(p, bad)
    # a grouped table proof checked against its instances in the wrong order
    p, proof = R.logup_case("grouped_tables")[0], proofs["grouped_tables"][0]
    swapped = dict(p, instances=p["instances"][::-1])
    with pytest.raises(AssertionError):
        _verify(swapped, proof)


def test_lookup_tree_and_merge_match_jax_live():
    from deepprove_tpu.fields import gf as jgf
    from deepprove_tpu.lookup import logup as jlogup

    rng = np.random.default_rng(120)
    cols = [rng.integers(0, R.P, size=16, dtype=np.uint64) for _ in range(2)]
    const, sep = R._ext(rng), R._ext(rng)
    j_den = jlogup.merge_columns(
        tuple(jgf.from_u64(c) for c in cols),
        jgf.ext_from_u64(np.uint64(const[0]), np.uint64(const[1])),
        jgf.ext_from_u64(np.uint64(sep[0]), np.uint64(sep[1])), 2,
    )
    j_nums, j_dens = jlogup._lookup_tree(j_den)
    den = logup.merge_columns(
        _cols(cols), gf.ext_scalar(const, "cpu"), gf.ext_scalar(sep, "cpu")
    )
    nums, dens = logup._lookup_tree(den)

    def pairs(e):
        a0, a1 = jgf.ext_to_u64(e)
        return list(zip(np.asarray(a0).tolist(), np.asarray(a1).tolist()))

    assert gf.ext_to_pairs(den) == pairs(j_den)
    assert [gf.ext_to_pairs(d) for d in dens] == [pairs(d) for d in j_dens]
    assert [gf.ext_to_pairs(n) for n in nums] == [pairs(n) for n in j_nums]


def test_tables_and_challenges_match_jax_host_code():
    from deepprove_tpu.transcript import BasicTranscript as JaxTranscript
    from deepprove_tpu.zkml import lookup_context as JLC

    types = [LC.TableType("clamping", (9,)), LC.TableType("range"), LC.TableType("relu"),
             LC.TableType("clamping", (8,))]
    jtypes = [JLC.TableType(t.kind, t.params) for t in types]
    assert [t.name() for t in sorted(types)] == [t.name() for t in sorted(jtypes)]
    rng = np.random.default_rng(121)
    for t, jt in zip(types, jtypes):
        merged, cols = t.table_columns()
        j_merged, j_cols = jt.table_columns()
        np.testing.assert_array_equal(merged.numpy(), j_merged)
        assert [gf.to_u64(c).tolist() for c in cols] == [np.asarray(c).tolist() for c in j_cols]
        assert t.multiplicity_poly_vars() == jt.multiplicity_poly_vars()
        assert t.num_columns() == jt.num_columns()
        pt = [R._ext(rng) for _ in range(t.multiplicity_poly_vars())]
        assert t.evaluate_table_columns(pt) == jt.evaluate_table_columns(pt)
        # the closed forms are the columns' MLEs
        assert t.evaluate_table_columns(pt) == [host.mle_eval_v(gf.to_u64(c), pt) for c in cols]
    ours = LC.ChallengeStorage.initialise(types, BasicTranscript(b"tbl"))
    theirs = JLC.ChallengeStorage.initialise(jtypes, JaxTranscript(b"tbl"))
    assert (ours.constant_challenge, ours.challenge_map) == (
        theirs.constant_challenge, theirs.challenge_map
    )
    # the attention slice's exp table too
    sm = LC.TableType.softmax(1.0, 5, 1 << 20)
    np.testing.assert_array_equal(sm.table_columns()[0].numpy(), JLC.TableType(sm.kind, sm.params).table_columns()[0])


def test_requant_spec_matches_jax():
    from deepprove_tpu.zkml.quantization import RequantSpec as JaxSpec

    rng = np.random.default_rng(122)
    v = rng.integers(-(1 << 24), 1 << 24, size=257)
    for mult, bits in ((1 / 128 / 4, 17), (1 / 128 / 1024, 25), (0.37, 20), (3e-6, 40)):
        ours, theirs = Q.RequantSpec.from_multiplier(mult, bits), JaxSpec.from_multiplier(mult, bits)
        assert ours == Q.RequantSpec(**{f: getattr(theirs, f) for f in R.REQUANT_FIELDS})
        assert (ours.shift, ours.clamping_size()) == (theirs.shift, theirs.clamping_size())
        vb = np.clip(v, -(1 << (bits - 1)), (1 << (bits - 1)) - 1)
        got = ours.apply(torch.from_numpy(vb)).numpy()
        np.testing.assert_array_equal(got, theirs.apply(vb))


class _PaddedTable:
    """A 6-row table: not a power of two, so it pads to 8 rows."""

    def name(self):
        return "six"

    def table_columns(self, device="cpu"):
        vals = self.merged_column(device)
        return vals.clone(), [vals]

    def merged_column(self, device="cpu"):
        return torch.tensor([10, 11, 12, 13, 14, 15], dtype=torch.int64, device=device)

    def row_offset(self):
        return None  # found by a search of its sorted column

    def num_columns(self):
        return 1

    def __lt__(self, other):
        return False


class _Ctx:
    class commitment_ctx:  # noqa: N801 - stands in for the CommitmentContext
        @staticmethod
        def commit_many(evals_list):
            return ["commitment"] * len(evals_list)

    device = torch.device("cpu")

    def __init__(self, op):
        self.steps_info = {0: type("N", (), {"op": op})()}

    def forward_order(self):
        return [0]


class _LookupNode:
    def gen_lookup_witness(self, node_id, ctx, step):
        vals = torch.tensor([10, 10, 10, 12, 15, 15, 12, 10])
        return [], {_PaddedTable(): vals}


def test_fractional_multiplicities_of_a_padded_table(monkeypatch):
    monkeypatch.setattr(LC.ChallengeStorage, "initialise", staticmethod(lambda tts, t: None))
    trace = type("T", (), {"steps": {0: None}})()
    _, _, (wit,) = LC.generate_lookup_witnesses(trace, _Ctx(_LookupNode()), None)
    p = host.P
    # rows 10, 11 repeat: count / 2 in the field; 12 once; 15 once
    want = [4 * pow(2, p - 2, p) % p, 0, 2, 0, 0, 2, 4 * pow(2, p - 2, p) % p, 0]
    assert gf.to_u64(wit.multiplicities).tolist() == want
    assert gf.to_u64(LC.table_columns_padded(_PaddedTable(), "cpu")[0]).tolist() == [10, 11, 12, 13, 14, 15, 10, 11]
