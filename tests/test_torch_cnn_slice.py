"""The port's CNN slice end to end on the CPU, held against the JAX
package's proofs of the same models (frozen in torch_reference.json by
make_torch_reference.py part `cnn`, checked against the JAX package by
test_torch_reference.py): (a) conv -> requant -> maxpool -> flatten ->
dense, (b) a stride-2 conv, (c) a tiny LeNet-shaped float model quantized
with the inference observer. Each proof must equal the JAX one field for
field; the port's verifier accepts it and rejects a changed output, a
changed first clearing message, a changed delegation round message, a
changed pooling zerocheck evaluation and a pooling proof that names another
variable gap than its layer's input width gives. Tolerance: exact equality."""

import copy

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.fields import host
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.zkml.convert import float_model_from_ops, model_from_layers
from deepprove_tpu_torch.zkml.float_model import quantize
from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
from deepprove_tpu_torch.zkml.tensor import Tensor

PROOF_PARTS = ("steps", "table_proofs", "shared_logup", "commit")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # these proves are thousands of small int64 ops: one thread is fastest,
    # and many threads thrash when other test processes share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _build(name):
    if name == "lenet":
        ops, xs = R.cnn_case(name)
        fm = float_model_from_ops(R.LENET_TINY["input_shape"], ops)
        model, s_in, _ = quantize(fm, "inference", xs, device="cpu")
        return model, s_in.quantize(xs[0])
    layers, x = R.cnn_case(name)
    return model_from_layers(layers, device="cpu"), x


@pytest.fixture(scope="module")
def proved():
    out = {}
    for name in R.CNN_CASES:
        model, x_np = _build(name)
        x = Tensor(torch.from_numpy(x_np))
        trace = model.run([x], device="cpu")
        ctx = Context.generate(model, device="cpu", **R.CNN_KW)
        proof = Prover(ctx, BasicTranscript(b"m2vec"), device="cpu").prove(trace)
        out[name] = (model, x, trace, ctx, proof)
    return out


def _verify(ctx, proof, x, outputs):
    verify(ctx, proof, IO([x], outputs), BasicTranscript(b"m2vec"), device="cpu")


def _bump(pair):
    return host.ext_add(pair, (1, 0))


@pytest.mark.parametrize("name", R.CNN_CASES)
def test_inference_matches_numpy_and_jax(proved, name):
    model, x, trace, _, _ = proved[name]
    ref = R.load()["cnn"][name]
    assert x.data.tolist() == ref["input"]
    got = trace.outputs[0].data.numpy()
    np.testing.assert_array_equal(got, R.numpy_eval(R.layer_records(model), x.data.numpy()))
    assert got.tolist() == ref["output"]


@pytest.mark.parametrize("name", R.CNN_CASES)
def test_proof_equals_jax_proof(proved, name):
    *_, proof = proved[name]
    ref = R.load()["cnn"][name]["proof"]
    for part in PROOF_PARTS:
        assert R.plain(getattr(proof, part)) == ref[part], part
    assert not proof.merges


@pytest.mark.parametrize("name", R.CNN_CASES)
def test_verifier_accepts(proved, name):
    _, x, trace, ctx, proof = proved[name]
    _verify(ctx, proof, x, trace.outputs)


def test_lenet_lookup_layout(proved):
    model, _, _, ctx, proof = proved["lenet"]
    kinds = [type(model.nodes[n].op).__name__ for n in model.forward_order()]
    assert kinds == ["Convolution", "Requant", "Relu", "Maxpool2D"] * 2 + ["Flatten"] + [
        "Dense", "Requant", "Relu", "Dense", "Requant"]
    # column sizes ascending: the last requant 4 (3 padded), the first dense
    # 8, pool 2 16, pool 1 and conv 2 64, conv 1 256
    sizes = [len(g.proof.output_claims[0].point) for g in proof.shared_logup]
    assert sizes == [2, 3, 4, 6, 8]
    assert "Range" in [t.name() for t in ctx.lookup]


@pytest.mark.parametrize("name", R.CNN_CASES)
def test_verifier_rejects_changed_output(proved, name):
    _, x, trace, ctx, proof = proved[name]
    bad = trace.outputs[0].data.clone()
    bad.view(-1)[0] += 1
    with pytest.raises(AssertionError):
        _verify(ctx, proof, x, [Tensor(bad)])


def _conv_node(proof):
    return min(nid for nid, p in proof.steps.items() if type(p).__name__ == "ConvProof")


def _pool_node(proof):
    return min(nid for nid, p in proof.steps.items() if type(p).__name__ == "PoolingProof")


@pytest.mark.parametrize("where", ["clearing", "delegation_inv", "delegation_fft", "pool_zerocheck", "pool_gap"])
def test_verifier_rejects_tampered_proof(proved, where):
    name = "strided" if where == "clearing" else "conv_pool_dense"
    _, x, trace, ctx, proof = proved[name]
    bad = copy.deepcopy(proof)
    if where == "clearing":
        msgs = bad.steps[_conv_node(bad)].clearing.round_messages
        msgs[0][0] = _bump(msgs[0][0])
    elif where == "pool_zerocheck":
        evals = bad.steps[_pool_node(bad)].zerocheck_evals
        evals[1] = _bump(evals[1])
    elif where == "pool_gap":
        bad.steps[_pool_node(bad)].variable_gap += 1
    else:
        chain = getattr(bad.steps[_conv_node(bad)], where)
        msgs = chain[0][1].round_messages
        msgs[1][2] = _bump(msgs[1][2])
    with pytest.raises(AssertionError):
        _verify(ctx, bad, x, trace.outputs)
