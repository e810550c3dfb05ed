"""The port's Dense-chain slice end to end on the CPU: the chain [16, 32, 8]
built once with numpy (torch_reference.dense_inputs) is proved by the port
through `convert.dense_chain_from_arrays`; the proof must be field-for-field
equal to the JAX package's proof of the same model, frozen in
torch_reference.json (checked against the JAX package by
test_torch_reference.py). The port's verifier accepts it and rejects a
tampered output or proof."""

import copy

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.zkml.convert import dense_chain_from_arrays
from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
from deepprove_tpu_torch.zkml.model import Model
from deepprove_tpu_torch.zkml.tensor import Tensor


@pytest.fixture(scope="module")
def proved():
    layers, x_np = R.dense_inputs()
    model = dense_chain_from_arrays(layers, device="cpu")
    x = Tensor(torch.from_numpy(x_np))
    trace = model.run([x], device="cpu")
    ctx = Context.generate(model, device="cpu", **R.DENSE_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec"), device="cpu").prove(trace)
    return layers, x, trace, ctx, proof


def _verify(ctx, proof, x, outputs):
    verify(ctx, proof, IO([x], outputs), BasicTranscript(b"m2vec"), device="cpu")


def test_inference_matches_numpy_and_jax(proved):
    layers, x, trace, _, _ = proved
    want = x.data.numpy()
    for w, b in layers:
        want = w @ want + b
    got = trace.outputs[0].data.numpy()
    np.testing.assert_array_equal(got, want)
    assert got.tolist() == R.load()["dense"]["output"]


def test_proof_equals_jax_proof(proved):
    *_, proof = proved
    got = R.plain({"steps": proof.steps, "commit": proof.commit})
    assert got == R.load()["dense"]["proof"]


def test_verifier_accepts(proved):
    _, x, trace, ctx, proof = proved
    _verify(ctx, proof, x, trace.outputs)


def test_verifier_rejects_tampered_output(proved):
    _, x, trace, ctx, proof = proved
    bad = trace.outputs[0].data.clone()
    bad[0] += 1
    with pytest.raises(AssertionError):
        _verify(ctx, proof, x, [Tensor(bad)])


def test_verifier_rejects_tampered_proof(proved):
    _, x, trace, ctx, proof = proved
    bad = copy.deepcopy(proof)
    a0, a1 = bad.steps[1].bias_eval
    bad.steps[1].bias_eval = ((a0 + 1) % R.P, a1)
    with pytest.raises(AssertionError):
        _verify(ctx, bad, x, trace.outputs)


def test_lookup_tables_sort_into_the_context():
    """Requant and ReLU register their tables; the context keeps them in
    sorted order and sizes the PCS for their multiplicity polys."""
    from deepprove_tpu_torch.zkml.layers.activation import Relu
    from deepprove_tpu_torch.zkml.layers.requant import Requant
    from deepprove_tpu_torch.zkml.quantization import RequantSpec

    model = Model()
    model.add_chain(Requant(spec=RequantSpec.from_multiplier(1 / 128 / 4, 17)))
    model.add_chain(Relu())
    ctx = Context.generate(model, device="cpu", **R.DENSE_KW)
    assert [t.name() for t in ctx.lookup] == ["Relu", "Range", "Clamping: 8"]
    assert ctx.commitment_ctx.params.max_message_size_log == 8
