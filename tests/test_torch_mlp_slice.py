"""The port's Dense -> Requant -> ReLU slice end to end on the CPU:
bench.py's MLP (`build_mlp_4m`) at the small width of
torch_reference.MLP_DIMS, built with numpy (torch_reference.mlp_inputs) and
carried across with the JAX package's requant specs through
`convert.mlp_chain_from_arrays`. Its proof must equal the JAX package's
proof of the same model field for field (frozen in torch_reference.json,
checked against the JAX package by test_torch_reference.py): two column
sizes (16 and 4) give two consolidated lookup groups, and the three tables
of 2^8 rows one grouped table proof. The port's verifier accepts it and
rejects a changed output, a changed lookup evaluation and a changed table
column claim. Tolerance: exact equality."""

import copy

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.fields import host
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.zkml import quantization as Q
from deepprove_tpu_torch.zkml.convert import mlp_chain_from_arrays
from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
from deepprove_tpu_torch.zkml.tensor import Tensor

PROOF_PARTS = ("steps", "table_proofs", "shared_logup", "commit")


@pytest.fixture(scope="module")
def proved():
    ref = R.load()["mlp"]
    layers, x_np = R.mlp_inputs()
    model = mlp_chain_from_arrays(layers, ref["specs"], device="cpu")
    x = Tensor(torch.from_numpy(x_np))
    trace = model.run([x], device="cpu")
    ctx = Context.generate(model, device="cpu", **R.MLP_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec"), device="cpu").prove(trace)
    return layers, x, trace, ctx, proof


def _verify(ctx, proof, x, outputs):
    verify(ctx, proof, IO([x], outputs), BasicTranscript(b"m2vec"), device="cpu")


def _bump(pair):
    return host.ext_add(pair, (1, 0))


def test_inference_matches_numpy_and_jax(proved):
    layers, x, trace, _, _ = proved
    want = x.data.numpy()
    for (w, b), spec in zip(layers, R.load()["mlp"]["specs"]):
        s = Q.RequantSpec(**spec)
        v = w @ want + b
        v = (v * s.fixed_point_multiplier + (1 << (s.shift - 1))) >> s.shift
        want = np.maximum(np.clip(v, Q.MIN, Q.MAX), 0)
    got = trace.outputs[0].data.numpy()
    np.testing.assert_array_equal(got[: len(want)], want)
    assert got.tolist() == R.load()["mlp"]["output"]


def test_requant_specs_are_derived_as_bench_does():
    layers, _ = R.mlp_inputs()
    model = mlp_chain_from_arrays(layers, device="cpu")
    specs = [model.nodes[i].op.spec for i in range(1, len(model.nodes), 3)]
    got = [{f: getattr(spec, f) for f in R.REQUANT_FIELDS} for spec in specs]
    assert got == R.load()["mlp"]["specs"]


def test_proof_equals_jax_proof(proved):
    *_, proof = proved
    ref = R.load()["mlp"]["proof"]
    for part in PROOF_PARTS:
        assert R.plain(getattr(proof, part)) == ref[part], part
    assert not proof.merges


def test_lookup_layout_has_two_sizes_and_one_grouped_table_proof(proved):
    *_, ctx, proof = proved
    assert [t.name() for t in ctx.lookup] == ["Relu", "Range", "Clamping: 8"]
    sizes = [g.proof.output_claims[0].point for g in proof.shared_logup]
    assert [len(p) for p in sizes] == [2, 4]  # columns of 4 and of 16 entries
    assert [len(tp.table_types) for tp in proof.table_proofs] == [3]


def test_verifier_accepts(proved):
    _, x, trace, ctx, proof = proved
    _verify(ctx, proof, x, trace.outputs)


def test_verifier_rejects_tampered_output(proved):
    _, x, trace, ctx, proof = proved
    bad = trace.outputs[0].data.clone()
    bad[0] += 1
    with pytest.raises(AssertionError):
        _verify(ctx, proof, x, [Tensor(bad)])


def test_verifier_rejects_tampered_lookup_evaluation(proved):
    _, x, trace, ctx, proof = proved
    for where in ("round_evaluation", "output_claim", "table_column"):
        bad = copy.deepcopy(proof)
        if where == "round_evaluation":
            evals = bad.shared_logup[1].proof.round_evaluations[2]
            evals[0] = _bump(evals[0])
        elif where == "output_claim":
            claim = bad.shared_logup[0].proof.output_claims[1]
            claim.eval = _bump(claim.eval)
        else:
            claim = bad.table_proofs[0].lookup.output_claims[2]
            claim.eval = _bump(claim.eval)
        with pytest.raises(AssertionError):
            _verify(ctx, bad, x, trace.outputs)
