"""The CNN slice's modules in the port against the JAX package on the same
numpy inputs, live on the CPU: the convolution's inference (stride 1 and 2)
and its frequency-domain weights, the delegation's partial-product tables,
the MLE fixes the conv prover uses, Maxpool's inference and diffs, the
shape ops, `quantize` (float arrays -> equal filters, biases, Requant specs
and scales), `pad_pass`, `load_onnx` on hand-written ONNX bytes, and one
`api.prove_onnx` -> `verify_proof` round trip. Integers and field values
must be equal; the quantization scales too (both packages run the same
float64 numpy operations in the same order)."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.fields import gf
from deepprove_tpu_torch.pcs import ntt
from deepprove_tpu_torch.poly import mle
from deepprove_tpu_torch.zkml import float_model as port_fm
from deepprove_tpu_torch.zkml.convert import float_model_from_ops, model_from_layers
from deepprove_tpu_torch.zkml.layers.convolution import Convolution, phi_partials
from deepprove_tpu_torch.zkml.layers.pooling import Maxpool2D
from deepprove_tpu_torch.zkml.layers.shape_ops import Flatten, Reshape
from deepprove_tpu_torch.zkml.padding import pad_pass
from deepprove_tpu_torch.zkml.tensor import Tensor
from test_parser import _field, _ld, _node, _tensor_proto, _value_info, _varint

P = gf.P


def naive_corr(x, w, bias):
    """O[i, y, c] = sum_{j, dy, dx} X[j, y + dy, c + dx] W[i, j, dy, dx] + bias[i], valid."""
    kw, kx, k, _ = w.shape
    n = x.shape[1]
    v = n - k + 1
    out = np.zeros((kw, n, n), dtype=np.int64)
    for i in range(kw):
        for y in range(v):
            for c in range(v):
                out[i, y, c] = sum(int((x[j, y : y + k, c : c + k] * w[i, j]).sum()) for j in range(kx)) + bias[i]
    return out


def _conv_pair(seed, kx, n, k, kw, stride):
    from deepprove_tpu.zkml.layers.convolution import Convolution as JaxConvolution

    rng = np.random.default_rng(seed)
    x = rng.integers(R.Q_MIN, R.Q_MAX + 1, size=(kx, n, n)).astype(np.int64)
    w = rng.integers(R.Q_MIN, R.Q_MAX + 1, size=(kw, kx, k, k)).astype(np.int64)
    b = rng.integers(R.Q_MIN, R.Q_MAX + 1, size=kw).astype(np.int64)
    port = Convolution(filter=torch.from_numpy(w), bias=torch.from_numpy(b), input_shape=(kx, n, n), stride=stride)
    jax_conv = JaxConvolution(filter=w, bias=b, input_shape=(kx, n, n), stride=stride)
    return x, w, b, port, jax_conv


@pytest.mark.parametrize("stride", [1, 2])
def test_conv_evaluate_matches_naive_and_jax(stride):
    from deepprove_tpu.zkml.tensor import Tensor as JaxTensor

    x, w, b, port, jax_conv = _conv_pair(51 + stride, 3, 8, 3, 3, stride)
    got = port.evaluate([Tensor(torch.from_numpy(x))])[0].data.numpy()
    full = naive_corr(x, w, b)
    ok = np.arange(8)[::stride] < 8 - 3 + 1
    want = np.zeros((4, 8, 8), dtype=np.int64)
    want[:3] = full
    want = want[:, ::stride, ::stride] * ok[None, :, None] * ok[None, None, :]
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_conv.evaluate([JaxTensor(x)])[0].data)
    assert port.output_bitsize() == jax_conv.output_bitsize()


def test_conv_freq_weights_equal_jax():
    from deepprove_tpu.fields import gf as jgf

    _, _, _, port, jax_conv = _conv_pair(54, 3, 8, 3, 3, 1)
    want = np.asarray(jgf.to_u64(jax_conv.freq_weights()))
    np.testing.assert_array_equal(gf.to_u64(port.freq_weights()), want)
    assert want.shape == (4 * 4 * 128,)


def _ext_point(seed, n):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=n, dtype=np.uint64), rng.integers(0, P, size=n, dtype=np.uint64)


def test_delegation_partial_products_equal_jax():
    from deepprove_tpu.fields import gf as jgf
    from deepprove_tpu.zkml.layers.convolution import _phi_partials_kernel

    a0, a1 = _ext_point(55, 5)
    omega = ntt.subgroup_gen(5)
    n_inv = pow(32, P - 2, P)
    want = _phi_partials_kernel(jgf.ext_from_u64(a0, a1), omega, 5, n_inv)
    got = phi_partials(gf.GF2(gf.from_u64(a0), gf.from_u64(a1)), omega, 5, n_inv)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        w0, w1 = jgf.ext_to_u64(w)
        np.testing.assert_array_equal(gf.to_u64(g.a0), np.asarray(w0))
        np.testing.assert_array_equal(gf.to_u64(g.a1), np.asarray(w1))


def test_fix_high_and_evaluate_equal_jax():
    from deepprove_tpu.fields import gf as jgf
    from deepprove_tpu.poly import mle as jmle

    vals = np.random.default_rng(56).integers(0, P, size=1 << 6, dtype=np.uint64)
    a0, a1 = _ext_point(57, 6)
    jpt, pt = jgf.ext_from_u64(a0, a1), gf.GF2(gf.from_u64(a0), gf.from_u64(a1))
    fixed = mle.fix_high_variables(gf.from_u64(vals), pt[:2])
    w0, w1 = jgf.ext_to_u64(jmle._fix_high_kernel(jgf.from_u64(vals), jpt, 2))
    np.testing.assert_array_equal(gf.to_u64(fixed.a0), np.asarray(w0))
    np.testing.assert_array_equal(gf.to_u64(fixed.a1), np.asarray(w1))
    e0, e1 = jgf.ext_to_u64(jmle._evaluate_kernel(jgf.from_u64(vals), jpt, 6))
    got = mle.evaluate(gf.from_u64(vals), pt)
    assert gf.ext_to_pairs(got.reshape(1)) == [(int(e0), int(e1))]


def test_maxpool_evaluate_and_diffs_equal_jax():
    from deepprove_tpu.zkml.layers.pooling import Maxpool2D as JaxMaxpool
    from deepprove_tpu.zkml.tensor import Tensor as JaxTensor

    x = np.random.default_rng(58).integers(R.Q_MIN, R.Q_MAX + 1, size=(3, 8, 8)).astype(np.int64)
    pool = Maxpool2D(input_shape=x.shape)
    out = pool.evaluate([Tensor(torch.from_numpy(x))])[0].data
    jout = JaxMaxpool().evaluate([JaxTensor(x)])[0].data
    np.testing.assert_array_equal(out.numpy(), jout)
    diffs = Maxpool2D.diffs(torch.from_numpy(x), out)
    jdiffs = JaxMaxpool()._diffs(x, jout)
    for d, jd in zip(diffs, jdiffs, strict=True):
        np.testing.assert_array_equal(d.numpy(), jd)
    assert min(int(d.min()) for d in diffs) == 0
    layout = [(n, k, t.name()) for n, k, t in pool.shared_lookup_layout()]
    assert layout == [(n, k, t.name()) for n, k, t in JaxMaxpool().shared_lookup_layout()] == [(4, 1, "Range")]


def test_shape_ops_pass_claims_through():
    x = Tensor(torch.arange(2 * 4 * 4).reshape(2, 4, 4))
    assert Flatten().evaluate([x])[0].shape == (32,)
    assert Reshape(shape=(4, 8)).evaluate([x])[0].shape == (4, 8)
    for op in (Flatten(), Reshape(shape=(32,))):
        assert not op.is_provable and not op.step_info(0, None).is_provable


def _jax_float_model(input_shape, ops):
    import make_torch_reference as M

    return M.jax_float_model(input_shape, ops)


@pytest.mark.parametrize("cfg", ["LENET_TINY", "LENET"])
def test_quantize_equals_jax(cfg):
    from deepprove_tpu.zkml.float_model import quantize as jax_quantize
    from deepprove_tpu.zkml.padding import pad_pass as jax_pad_pass

    config = getattr(R, cfg)
    ops, xs = R.lenet_float_ops(config, np.random.default_rng(0))
    fm = float_model_from_ops(config["input_shape"], ops)
    jfm = _jax_float_model(config["input_shape"], ops)
    if cfg == "LENET":  # the 400 valid columns spread over the padded grid
        assert pad_pass(fm) == jax_pad_pass(jfm)
    q, s_in, s_out = port_fm.quantize(fm, "inference", xs, device="cpu")
    jq, js_in, js_out = jax_quantize(jfm, "inference", xs)
    recs, jrecs = R.layer_records(q), R.layer_records(jq)
    assert [k for k, _ in recs] == [k for k, _ in jrecs]
    for (kind, f), (_, jf) in zip(recs, jrecs):
        assert f.keys() == jf.keys()
        for key in f:
            np.testing.assert_array_equal(np.asarray(f[key]), np.asarray(jf[key]), err_msg=f"{kind}.{key}")
    for s, js in ((s_in, js_in), (s_out, js_out)):
        assert dataclasses.astuple(s) == dataclasses.astuple(js)
    np.testing.assert_array_equal(s_in.quantize(xs[0]), js_in.quantize(xs[0]))


def test_quantize_absolute_max_equals_jax():
    from deepprove_tpu.zkml.float_model import quantize as jax_quantize

    ops, _ = R.lenet_float_ops(R.LENET_TINY, np.random.default_rng(1))
    q, _, _ = port_fm.quantize(float_model_from_ops(R.LENET_TINY["input_shape"], ops), device="cpu")
    jq, _, _ = jax_quantize(_jax_float_model(R.LENET_TINY["input_shape"], ops))
    for (_, f), (_, jf) in zip(R.layer_records(q), R.layer_records(jq), strict=True):
        for key in f:
            np.testing.assert_array_equal(np.asarray(f[key]), np.asarray(jf[key]))


def test_model_from_layers_carries_a_jax_model_across():
    import make_torch_reference as M

    layers, x = R.cnn_case("conv_pool_dense")
    jax_model = M.jax_model(layers)
    port = model_from_layers(R.layer_records(jax_model), device="cpu")
    recs, jrecs = R.layer_records(port), R.layer_records(jax_model)
    for (k, f), (jk, jf) in zip(recs, jrecs, strict=True):
        assert k == jk and f.keys() == jf.keys()
        for key in f:
            np.testing.assert_array_equal(np.asarray(f[key]), np.asarray(jf[key]))
    out = port.run([Tensor(torch.from_numpy(x))], device="cpu").outputs[0].data.numpy()
    np.testing.assert_array_equal(out, R.numpy_eval(jrecs, x))


def test_pad_pass_equals_jax_on_the_lenet_shapes():
    from deepprove_tpu.zkml.padding import pad_pass as jax_pad_pass

    rng = np.random.default_rng(1)
    ops = [("conv", rng.uniform(-1, 1, size=(6, 3, 5, 5)), np.zeros(6), 1), ("maxpool", None, None, 1),
           ("conv", rng.uniform(-1, 1, size=(16, 6, 5, 5)), np.zeros(16), 1), ("maxpool", None, None, 1),
           ("flatten", None, None, 1), ("dense", rng.uniform(-1, 1, size=(10, 400)), np.zeros(10), 1)]
    fm, jfm = float_model_from_ops((3, 32, 32), ops), _jax_float_model((3, 32, 32), ops)
    shapes = pad_pass(fm)
    assert shapes == jax_pad_pass(jfm)
    assert shapes[3] == ((16, 8, 8), (16, 5, 5))
    np.testing.assert_array_equal(fm.ops[5][0].weight, jfm.ops[5][0].weight)
    assert fm.ops[5][0].weight.shape == (10, 1024)
    assert pad_pass(fm) == shapes  # idempotent
    x = rng.uniform(-1, 1, size=(3, 32, 32))
    np.testing.assert_array_equal(fm.forward(x), jfm.forward(x))
    straddle = float_model_from_ops((1, 8, 8), [("conv", np.zeros((1, 1, 4, 4)), np.zeros(1), 1),
                                                ("maxpool", None, None, 1)])
    with pytest.raises(NotImplementedError):
        pad_pass(straddle)


def test_pad_and_add_wait_for_a_later_slice():
    """FPad and FAdd, once left for a later slice, now run and quantize as
    the JAX package's: a pad's float output and its quantized layer
    (Pad2D), a residual add's (requant each branch, Add, renormalize)."""
    from deepprove_tpu.zkml import float_model as jax_fm

    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, size=(1, 4, 4))
    fm, jfm = port_fm.FloatModel(input_shape=(1, 4, 4)), jax_fm.FloatModel(input_shape=(1, 4, 4))
    for m, mod in ((fm, port_fm), (jfm, jax_fm)):
        m.add(mod.FPad(pad=1))
        m.add_node(mod.FAdd(), [0, 0])
    np.testing.assert_array_equal(fm.forward(x), jfm.forward(x))
    assert fm.forward(x).shape == (1, 8, 8)
    q, s_in, s_out = port_fm.quantize(fm, "inference", [x], device="cpu")
    jq, js_in, js_out = jax_fm.quantize(jfm, "inference", [x])
    assert [type(q.nodes[n].op).__name__ for n in q.forward_order()] == [
        "Pad2D", "Requant", "Requant", "Add", "Requant"]
    assert [type(jq.nodes[n].op).__name__ for n in jq.forward_order()] == [
        "Pad2D", "Requant", "Requant", "Add", "Requant"]
    assert [(s.min, s.max, s.scale) for s in (s_in, s_out)] == [(s.min, s.max, s.scale) for s in (js_in, js_out)]
    for n in q.forward_order():
        assert [(e.node, e.index) for e in q.nodes[n].inputs] == [(e.node, e.index) for e in jq.nodes[n].inputs]
        if hasattr(q.nodes[n].op, "spec"):
            assert dataclasses.asdict(q.nodes[n].op.spec) == dataclasses.asdict(jq.nodes[n].op.spec)
    xq = s_in.quantize(x)
    got = q.run([Tensor(torch.from_numpy(xq))], device="cpu").outputs[0].data.numpy()
    from deepprove_tpu.zkml.tensor import Tensor as JaxTensor

    np.testing.assert_array_equal(got, jq.run([JaxTensor(xq)]).outputs[0].data)


def _ints_attr(name, vals):
    return _ld(1, name.encode()) + b"".join(_field(8, 0, _varint(v)) for v in vals) + _field(20, 0, _varint(7))


def write_onnx(path, input_shape, ops):
    """ONNX bytes of a float chain of `R.lenet_float_ops`' form: Conv (with
    its strides and zero pads), Relu, MaxPool, Flatten, Gemm (transB = 1),
    and the last dense layer as MatMul + Add."""
    nodes, inits, cur = [], [], "input"
    last_dense = max(i for i, op in enumerate(ops) if op[0] == "dense")
    for i, (kind, w, b, stride) in enumerate(ops):
        out = f"t{i}"
        if kind == "conv":
            inits += [_tensor_proto(f"w{i}", w), _tensor_proto(f"b{i}", b)]
            attrs = _ld(5, _ints_attr("strides", [stride, stride])) + _ld(5, _ints_attr("pads", [0, 0, 0, 0]))
            nodes.append(_node("Conv", [cur, f"w{i}", f"b{i}"], [out]) + attrs)
        elif kind == "dense" and i == last_dense:
            inits += [_tensor_proto(f"w{i}", w.T), _tensor_proto(f"b{i}", b)]
            nodes.append(_node("MatMul", [cur, f"w{i}"], [f"m{i}"]))
            nodes.append(_node("Add", [f"m{i}", f"b{i}"], [out]))
        elif kind == "dense":
            inits += [_tensor_proto(f"w{i}", w), _tensor_proto(f"b{i}", b)]
            trans_b = _ld(5, _ld(1, b"transB") + _field(3, 0, _varint(1)) + _field(20, 0, _varint(2)))
            nodes.append(_node("Gemm", [cur, f"w{i}", f"b{i}"], [out]) + trans_b)
        elif kind == "maxpool":
            nodes.append(_node("MaxPool", [cur], [out]) + _ld(5, _ints_attr("kernel_shape", [2, 2])))
        else:
            nodes.append(_node({"relu": "Relu", "flatten": "Flatten"}[kind], [cur], [out]))
        cur = out
    graph = b"".join(_ld(1, n) for n in nodes) + b"".join(_ld(5, t) for t in inits)
    graph += _ld(11, _value_info("input", (1,) + tuple(input_shape)))
    with open(path, "wb") as f:
        f.write(_ld(7, graph))


def _small_cnn(seed, input_shape, c_out, k, dense):
    rng = np.random.default_rng(seed)
    c_in, n, _ = input_shape
    flat = c_out * ((n - k + 1) // 2) ** 2
    ops = [("conv", rng.uniform(-0.5, 0.5, size=(c_out, c_in, k, k)), rng.uniform(-0.1, 0.1, size=c_out), 1),
           ("relu", None, None, 1), ("maxpool", None, None, 1), ("flatten", None, None, 1)]
    for i, rows in enumerate(dense):
        ops.append(("dense", rng.uniform(-0.5, 0.5, size=(rows, flat)), rng.uniform(-0.1, 0.1, size=rows), 1))
        if i < len(dense) - 1:
            ops.append(("relu", None, None, 1))
        flat = rows
    return ops, [rng.uniform(-1, 1, size=input_shape) for _ in range(2)]


def test_load_onnx_equals_jax(tmp_path):
    from deepprove_tpu.parser.onnx import load_onnx as jax_load_onnx
    from deepprove_tpu_torch.parser.onnx import load_onnx

    ops, xs = _small_cnn(59, (3, 8, 8), 4, 3, (5, 3))
    path = str(tmp_path / "cnn.onnx")
    write_onnx(path, (3, 8, 8), ops)
    fm, jfm = load_onnx(path), jax_load_onnx(path)
    assert fm.input_shape == jfm.input_shape == (3, 8, 8)
    assert [type(op).__name__ for op, _ in fm.ops] == [type(op).__name__ for op, _ in jfm.ops]
    assert [ins for _, ins in fm.ops] == [ins for _, ins in jfm.ops]
    for (op, _), (jop, _) in zip(fm.ops, jfm.ops):
        for f in ("weight", "bias", "stride"):
            if hasattr(jop, f):
                np.testing.assert_array_equal(np.asarray(getattr(op, f)), np.asarray(getattr(jop, f)))
    assert fm.ops[4][0].weight.shape == (5, 4 * 4 * 4)  # pad_pass: 36 valid columns over 64
    np.testing.assert_array_equal(fm.forward(xs[0]), jfm.forward(xs[0]))


@pytest.fixture
def one_torch_thread():
    # a prove is thousands of small int64 ops: one thread is fastest, and
    # many threads thrash when other test processes share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_api_prove_onnx_verifies_on_the_cpu(tmp_path, one_torch_thread):
    from deepprove_tpu_torch.api import prove_onnx, verify_proof

    ops, xs = _small_cnn(60, (1, 4, 4), 2, 1, (3,))
    path = str(tmp_path / "tiny.onnx")
    write_onnx(path, (1, 4, 4), ops)
    res = prove_onnx(path, xs, strategy="inference", device="cpu", **R.CNN_KW)
    verify_proof(res)
    assert len(res.outputs_dequantized) == 1
    bad = res.io.outputs[0].data.clone()
    bad[0] += 1
    res.io.outputs[0] = Tensor(bad)
    with pytest.raises(AssertionError):
        verify_proof(res)
