"""The port's residual slice on the CPU, held against the JAX package:
residual Add with fan-out claim merging, Pad2D, FPad/FAdd quantization and
the ONNX Add and padded Conv. The five cases of torch_reference.py
`RESIDUAL_CASES` (tests/test_fanout.py's residual, the add of two dense
branches of tests/test_zkml_layers.py:25, tests/test_pad.py's pad alone and
before a conv, tests/test_capture_and_dag_parser.py:34's residual float
DAG) are proved once each; every proof must equal the JAX one frozen in
torch_reference.json (part `residual`, made by make_torch_reference.py,
checked by test_torch_reference.py) field for field, merges included; the
port's verifier accepts it and rejects a changed output and a changed
merge. The inference and the host functions are compared with the JAX
package live. Tolerance: exact equality."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
from deepprove_tpu_torch.zkml.tensor import Tensor
from test_parser import _field, _ld, _node, _tensor_proto, _value_info, _varint


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # these proves are thousands of small int64 ops: one thread is fastest,
    # and many threads thrash when other test processes share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def proved():
    out = {}
    for name in R.RESIDUAL_CASES:
        model, xs = R.port_graph(R.graph_case(name), "cpu")
        xs = [Tensor(torch.from_numpy(np.asarray(x, dtype=np.int64))) for x in xs]
        trace = model.run(xs, device="cpu")
        ctx = Context.generate(model, device="cpu", **R.RESIDUAL_KW)
        proof = Prover(ctx, BasicTranscript(b"m2vec"), device="cpu").prove(trace)
        out[name] = (model, xs, trace, ctx, proof)
    return out


def _verify(ctx, proof, xs, outputs):
    verify(ctx, proof, IO(xs, outputs), BasicTranscript(b"m2vec"), device="cpu")


@pytest.mark.parametrize("name", R.RESIDUAL_CASES)
def test_inference_equals_jax(proved, name):
    import make_torch_reference as M

    _, xs, trace, _, _ = proved[name]
    jmodel, jxs = M.jax_graph(R.graph_case(name))
    ref = R.load()["residual"][name]
    assert [x.data.tolist() for x in xs] == [np.asarray(x.data).tolist() for x in jxs] == ref["inputs"]
    got = trace.outputs[0].data.tolist()
    assert got == np.asarray(jmodel.run(jxs).outputs[0].data).tolist() == ref["output"]


@pytest.mark.parametrize("name", R.RESIDUAL_CASES)
def test_proof_equals_jax_proof(proved, name):
    *_, proof = proved[name]
    ref = R.load()["residual"][name]["proof"]
    for part in R.GRAPH_PROOF_PARTS:
        assert R.plain(getattr(proof, part)) == ref[part], part
    # a wire feeding two consumers is merged: the dense output of the
    # residual, the first dense of the float DAG (its relu and its add)
    assert bool(proof.merges) == (name in ("fanout", "residual_float"))


@pytest.mark.parametrize("name", R.RESIDUAL_CASES)
def test_verifier_accepts(proved, name):
    _, xs, trace, ctx, proof = proved[name]
    _verify(ctx, proof, xs, trace.outputs)


@pytest.mark.parametrize("name", R.RESIDUAL_CASES)
def test_verifier_rejects_changed_output(proved, name):
    _, xs, trace, ctx, proof = proved[name]
    bad = trace.outputs[0].data.clone()
    bad.view(-1)[0] += 1
    with pytest.raises(AssertionError):
        _verify(ctx, proof, xs, [Tensor(bad)])


@pytest.mark.parametrize("where", ["merged_eval", "merge_message", "add_split", "pad_message"])
def test_verifier_rejects_tampered_proof(proved, where):
    name = {"add_split": "add_branches", "pad_message": "pad"}.get(where, "fanout")
    _, xs, trace, ctx, proof = proved[name]
    bad = copy.deepcopy(proof)
    if where == "merged_eval":
        (sp,) = bad.merges.values()
        sp.evals[1] = host.ext_add(sp.evals[1], (1, 0))
    elif where == "merge_message":
        (sp,) = bad.merges.values()
        sp.sumcheck.round_messages[0][0] = host.ext_add(sp.sumcheck.round_messages[0][0], (1, 0))
    elif where == "add_split":
        add = bad.steps[max(bad.steps)]
        add.left_eval = host.ext_add(add.left_eval, (1, 0))
        add.right_eval = host.ext_sub(add.right_eval, (1, 0))
    else:
        msgs = bad.steps[0].sumcheck.round_messages
        msgs[0][0] = host.ext_add(msgs[0][0], (1, 0))
    with pytest.raises(AssertionError):
        _verify(ctx, bad, xs, trace.outputs)


def test_merge_order_follows_the_jax_prover(proved):
    """The merge sits at its producer's place in the backward order, keyed
    (node, wire), with the consumers' claims in (consumer, slot) order."""
    model, *_, proof = proved["fanout"]
    assert list(proof.merges) == [(0, 0)]
    assert model.consumers_of_wire(0, 0) == [(1, 0), (2, 0)]


def test_pad_weights_and_closed_form_equal_jax():
    import jax.numpy as jnp
    from deepprove_tpu.fields import gf as jgf
    from deepprove_tpu.zkml.layers import pad as jpad
    from deepprove_tpu_torch.zkml.layers import pad

    rng = np.random.default_rng(140)
    for p, log_n, log_no, log_c in ((1, 2, 3, 1), (3, 2, 4, 2)):  # each a JAX compile
        pts = [[R._ext(rng) for _ in range(k)] for k in (log_no, log_no, log_c)]
        w = pad.pad_weights(*[gf.ext_from_pairs(pt, "cpu") for pt in pts], p, log_n)
        jpts = [jgf.ext_from_u64(jnp.asarray([a for a, _ in pt], dtype=jnp.uint64),
                                 jnp.asarray([b for _, b in pt], dtype=jnp.uint64)) for pt in pts]
        jw = jpad._pad_weights_kernel(*jpts, p, log_n, log_no, log_c)
        a0, a1 = jgf.ext_to_u64(jw)
        assert gf.ext_to_pairs(w) == list(zip(np.asarray(a0).tolist(), np.asarray(a1).tolist()))
        t = [R._ext(rng) for _ in range(log_n)]
        assert pad.eqshift_closed(pts[0], t, p) == jpad._eqshift_closed(pts[0], t, p)


def test_pad_and_add_evaluate_equal_jax():
    from deepprove_tpu.zkml.layers.add import Add as JaxAdd
    from deepprove_tpu.zkml.layers.pad import Pad2D as JaxPad2D
    from deepprove_tpu.zkml.tensor import Tensor as JaxTensor
    from deepprove_tpu_torch.zkml.layers.add import Add
    from deepprove_tpu_torch.zkml.layers.pad import Pad2D

    rng = np.random.default_rng(141)
    for c, n, p in ((2, 4, 1), (3, 2, 2), (1, 8, 3)):
        x = rng.integers(R.Q_MIN, R.Q_MAX + 1, size=(c, n, n)).astype(np.int64)
        got = Pad2D(pad=p, input_shape=(c, n, n)).evaluate([Tensor(torch.from_numpy(x))])[0].data
        want = JaxPad2D(pad=p, input_shape=(c, n, n)).evaluate([JaxTensor(x)])[0].data
        np.testing.assert_array_equal(got.numpy(), want)
        got = Add().evaluate([Tensor(torch.from_numpy(x)), Tensor(torch.from_numpy(x * 3))])[0].data
        np.testing.assert_array_equal(got.numpy(), JaxAdd().evaluate([JaxTensor(x), JaxTensor(x * 3)])[0].data)


def test_residual_float_quantization_equals_jax():
    import make_torch_reference as M
    from deepprove_tpu_torch.zkml.convert import float_model_from_graph
    from deepprove_tpu_torch.zkml.float_model import quantize

    case = R.graph_case("residual_float")
    fm = float_model_from_graph(case["input_shape"], case["float"])
    q, s_in, s_out = quantize(fm, "inference", case["cal"], device="cpu")
    jq, _ = M.jax_graph(case)
    assert [type(q.nodes[n].op).__name__ for n in q.forward_order()] == [
        type(jq.nodes[n].op).__name__ for n in jq.forward_order()]
    for n in q.forward_order():
        assert [(e.node, e.index) for e in q.nodes[n].inputs] == [(e.node, e.index) for e in jq.nodes[n].inputs]
        if hasattr(q.nodes[n].op, "spec"):
            assert dataclasses.asdict(q.nodes[n].op.spec) == dataclasses.asdict(jq.nodes[n].op.spec)
    x = case["cal"][0]
    assert np.max(np.abs(fm.forward(x) - (np.asarray(
        q.run([Tensor(torch.from_numpy(s_in.quantize(x)))], device="cpu").outputs[0].data) * s_out.scale))) < 0.25


def _ints_attr(name, vals):
    return _ld(1, name.encode()) + b"".join(_field(8, 0, _varint(v)) for v in vals) + _field(20, 0, _varint(7))


def _write_onnx(path, rng, kind):
    """kind "pad": a Conv with pads 1 on a 1 x 4 x 4 input, then Relu.
    kind "residual": Gemm, then Gemm -> Relu -> MatMul added to the first
    Gemm's output (a residual Add of two node outputs)."""
    trans_b = _ld(5, _ld(1, b"transB") + _field(3, 0, _varint(1)) + _field(20, 0, _varint(2)))
    if kind == "pad":
        inits = [_tensor_proto("wc", rng.uniform(-0.5, 0.5, size=(2, 1, 3, 3))),
                 _tensor_proto("bc", rng.uniform(-0.1, 0.1, 2))]
        attrs = _ld(5, _ints_attr("strides", [1, 1])) + _ld(5, _ints_attr("pads", [1, 1, 1, 1]))
        nodes = [_node("Conv", ["input", "wc", "bc"], ["c"]) + attrs, _node("Relu", ["c"], ["out"])]
        shape = (1, 1, 4, 4)
    else:
        w0, w1, w2 = (rng.uniform(-0.5, 0.5, size=(8, 8)) for _ in range(3))
        inits = [_tensor_proto("w0", w0), _tensor_proto("b0", rng.uniform(-0.1, 0.1, 8)), _tensor_proto("w1", w1),
                 _tensor_proto("b1", rng.uniform(-0.1, 0.1, 8)), _tensor_proto("w2", w2.T)]
        nodes = [
            _node("Gemm", ["input", "w0", "b0"], ["g0"]) + trans_b,
            _node("Gemm", ["g0", "w1", "b1"], ["g1"]) + trans_b,
            _node("Relu", ["g1"], ["g1r"]),
            _node("MatMul", ["g1r", "w2"], ["m2"]),
            _node("Add", ["g0", "m2"], ["out"]),
        ]
        shape = (1, 8)
    graph = b"".join(_ld(1, n) for n in nodes) + b"".join(_ld(5, t) for t in inits)
    graph += _ld(11, _value_info("input", shape))
    with open(path, "wb") as f:
        f.write(_ld(7, graph))


@pytest.mark.parametrize("kind", ["pad", "residual"])
def test_onnx_add_and_pad_equal_jax(tmp_path, kind):
    from deepprove_tpu.parser.onnx import load_onnx as jax_load_onnx
    from deepprove_tpu.zkml.float_model import quantize as jax_quantize
    from deepprove_tpu_torch.parser.onnx import load_onnx
    from deepprove_tpu_torch.zkml.float_model import quantize

    rng = np.random.default_rng(142)
    path = str(tmp_path / f"{kind}.onnx")
    _write_onnx(path, rng, kind)
    fm, jfm = load_onnx(path), jax_load_onnx(path)
    kinds = [type(op).__name__ for op, _ in fm.ops]
    assert kinds == [type(op).__name__ for op, _ in jfm.ops]
    assert kinds == (["FPad", "FConv", "FRelu"] if kind == "pad" else ["FDense", "FDense", "FRelu", "FDense", "FAdd"])
    assert [ins for _, ins in fm.ops] == [ins for _, ins in jfm.ops]
    for (op, _), (jop, _) in zip(fm.ops, jfm.ops):
        for f in ("weight", "bias", "stride", "pad"):
            if hasattr(jop, f):
                np.testing.assert_array_equal(np.asarray(getattr(op, f)), np.asarray(getattr(jop, f)))
    xs = [rng.uniform(-1, 1, size=fm.input_shape) for _ in range(2)]
    np.testing.assert_array_equal(fm.forward(xs[0]), jfm.forward(xs[0]))
    q, _, _ = quantize(fm, "inference", xs, device="cpu")
    jq, _, _ = jax_quantize(jfm, "inference", xs)
    assert [type(q.nodes[n].op).__name__ for n in q.forward_order()] == [
        type(jq.nodes[n].op).__name__ for n in jq.forward_order()]


def test_onnx_residual_proves_through_the_api(tmp_path):
    from deepprove_tpu_torch.api import prove_onnx, verify_proof

    rng = np.random.default_rng(143)
    path = str(tmp_path / "residual.onnx")
    _write_onnx(path, rng, "residual")
    xs = [rng.uniform(-1, 1, size=8) for _ in range(2)]
    result = prove_onnx(path, xs, strategy="inference", device="cpu", **R.RESIDUAL_KW)
    assert list(result.proof.merges) == [(1, 0)]  # the first dense's requant feeds the add and a dense
    verify_proof(result)
