"""Freeze the JAX package's outputs that the PyTorch port is held against.

Proving with the JAX package on the CPU takes minutes per call (XLA
compiles every shape), far beyond what the `tests/test_torch_*` files may
spend. So this script computes them once, on the seeded numpy inputs of
`torch_reference.py`, and writes `torch_reference.json`; the tests and
`chip_smoke.py` compare the port's outputs with it field for field.
`tests/test_torch_reference.py` recomputes the whole file with the JAX
package and checks that it is unchanged (`-m jax_reference`), and the
sumcheck, the cheapest part, is recomputed live by
`test_torch_sumcheck.py`. Regenerate after any change to those inputs,
the whole file or only the named top-level parts:

    JAX_PLATFORMS=cpu python tests/make_torch_reference.py [part ...]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch_reference as R  # noqa: E402
from deepprove_tpu import glue  # noqa: E402
from deepprove_tpu.fields import gf, host  # noqa: E402
from deepprove_tpu.lookup import logup  # noqa: E402
from deepprove_tpu.pcs import basefold  # noqa: E402
from deepprove_tpu.sumcheck import VirtualPolynomial, prove  # noqa: E402
from deepprove_tpu.transcript import BasicTranscript  # noqa: E402
from deepprove_tpu.transcript.session import DeviceTranscript  # noqa: E402
from deepprove_tpu.zkml.iop import Context, Prover, verify  # noqa: E402
from deepprove_tpu.zkml.iop.verifier import IO  # noqa: E402
from deepprove_tpu.zkml.float_model import FConv, FDense, FFlatten, FloatModel, FMaxpool, FRelu, quantize  # noqa: E402
from deepprove_tpu.zkml.layers.activation import Relu  # noqa: E402
from deepprove_tpu.zkml.layers.convolution import Convolution  # noqa: E402
from deepprove_tpu.zkml.layers.dense import Dense  # noqa: E402
from deepprove_tpu.zkml.layers.pooling import Maxpool2D  # noqa: E402
from deepprove_tpu.zkml.layers.requant import Requant  # noqa: E402
from deepprove_tpu.zkml.layers.shape_ops import Flatten  # noqa: E402
from deepprove_tpu.zkml.quantization import BIT_LEN, RequantSpec  # noqa: E402
from deepprove_tpu.zkml.model import Model  # noqa: E402
from deepprove_tpu.zkml.tensor import Tensor  # noqa: E402


def sumcheck_reference() -> dict:
    a, b, (c0, c1) = R.sumcheck_inputs()
    vp = VirtualPolynomial.new(R.SUMCHECK_NUM_VARS)
    vp.add_mle(gf.from_u64(a))
    vp.add_mle(gf.from_u64(b))
    vp.add_mle(gf.ext_from_u64(c0, c1))
    for coeff, factors in R.SUMCHECK_PRODUCTS:
        vp.add_product(coeff, factors)
    o = prove(vp, BasicTranscript(R.SUMCHECK_LABEL))
    return R.plain({"proof": o.proof, "final_evals": o.final_evals})


def basefold_reference(name: str) -> dict:
    """Commit and open one of the two polys of `R.basefold_inputs` ("rs",
    "trivial"), or ("batch") batch-open the three of `R.basefold_batch_inputs`."""
    if name == "batch":
        polys, points = R.basefold_batch_inputs()
        params = basefold.setup(max(R.BASEFOLD_BATCH_LOGS), **R.BASEFOLD_KW)
        comms = [basefold.commit(params, gf.from_u64(p)) for p in polys]
        evals = [basefold.BatchEvaluation(poly=i, point=i, value=host.mle_eval_v(p, pt))
                 for i, (p, pt) in enumerate(zip(polys, points))]
        proof = basefold.batch_open(params, [gf.from_u64(p) for p in polys], comms, points, evals,
                                    BasicTranscript(R.BASEFOLD_LABEL))
        basefold.batch_verify(params, [c.commitment for c in comms], points, evals, proof,
                              BasicTranscript(R.BASEFOLD_LABEL))
        return {"roots": [R.plain(c.commitment.root) for c in comms], "proof": R.plain(proof)}
    big, big_pt, small, small_pt = R.basefold_inputs()
    evals, pt = (big, big_pt) if name == "rs" else (small, small_pt)
    params = basefold.setup(R.BASEFOLD_MAX_LOG, **R.BASEFOLD_KW)
    comm = basefold.commit(params, gf.from_u64(evals))
    proof = basefold.open(params, comm, pt, BasicTranscript(R.BASEFOLD_LABEL))
    basefold.verify(
        params, comm.commitment, pt, host.mle_eval_v(evals, pt), proof,
        BasicTranscript(R.BASEFOLD_LABEL),
    )
    return {"root": R.plain(comm.commitment.root), "proof": R.plain(proof)}


def dense_reference() -> dict:
    layers, x_np = R.dense_inputs()
    model = Model()
    for w, bias in layers:
        model.add_chain(Dense(matrix=w, bias=bias))
    x = Tensor(x_np)
    trace = model.run([x])
    ctx = Context.generate(model, **R.DENSE_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec")).prove(trace)
    verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"))
    assert not proof.table_proofs and not proof.merges and not proof.shared_logup
    return {
        "output": R.plain(trace.outputs[0].data),
        "proof": {"steps": R.plain(proof.steps), "commit": R.plain(proof.commit)},
    }


def _logup_proof(p: dict):
    cols = lambda cs: [gf.from_u64(c) for c in cs]  # noqa: E731
    if p["kind"] == "lookup":
        inp = logup.LogUpInput.new_lookup(cols(p["columns"]), p["const"], p["sep"], p["cpi"])
        return logup.batch_prove(inp, BasicTranscript(p["label"]))
    if p["kind"] == "table":
        inp = logup.LogUpInput.new_table(cols(p["columns"]), gf.from_u64(p["mult"]), p["const"], p["sep"])
        return logup.batch_prove(inp, BasicTranscript(p["label"]))
    dt = DeviceTranscript.from_host(BasicTranscript(p["label"]))
    if p["kind"] == "grouped_lookups":
        proof = logup.batch_prove_grouped([(cols(c), k, s) for c, k, s in p["instances"]], dt)
    else:
        proof = logup.batch_prove_grouped_tables(
            [(cols(c), gf.from_u64(m), k, s) for c, m, k, s in p["instances"]], dt
        )
    return glue.materialize(proof)


def logup_reference(name: str) -> list:
    """The JAX proofs of one logup case of `R.logup_case`."""
    return [R.plain(_logup_proof(p)) for p in R.logup_case(name)]


def mlp_reference() -> dict:
    """bench.py's build_mlp_4m chain (Dense -> Requant -> ReLU a layer) at
    R.MLP_DIMS, proved and verified with the JAX package."""
    layers, x_np = R.mlp_inputs()
    model = Model()
    specs = []
    for w, bias in layers:
        d = Dense(matrix=w, bias=bias)
        spec = RequantSpec.from_multiplier(1.0 / (1 << (BIT_LEN - 1)) / w.shape[1], d.output_bitsize())
        model.add_chain(d)
        model.add_chain(Requant(spec=spec))
        model.add_chain(Relu())
        specs.append({f: getattr(spec, f) for f in R.REQUANT_FIELDS})
    x = Tensor(x_np)
    trace = model.run([x])
    ctx = Context.generate(model, **R.MLP_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec")).prove(trace)
    verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"))
    assert not proof.merges
    return {
        "output": R.plain(trace.outputs[0].data),
        "specs": specs,
        "proof": {k: R.plain(getattr(proof, k)) for k in ("steps", "table_proofs", "shared_logup", "commit")},
    }


def jax_model(layers) -> Model:
    """The JAX package's Model of [(kind, fields)] (`R.cnn_case`'s layer form);
    a requant given only a multiplier takes its bit size from the layer before."""
    model, prev = Model(), None
    for kind, f in layers:
        if kind == "conv":
            op = Convolution(filter=f["filter"], bias=f["bias"], input_shape=f["input_shape"], stride=f["stride"])
        elif kind == "dense":
            op = Dense(matrix=f["matrix"], bias=f["bias"])
        elif kind == "requant":
            op = Requant(spec=RequantSpec.from_multiplier(f["multiplier"], prev.output_bitsize()))
        else:
            op = {"relu": Relu, "maxpool": Maxpool2D, "flatten": Flatten}[kind]()
        model.add_chain(op)
        prev = op
    return model


def jax_float_model(input_shape, ops) -> FloatModel:
    """The JAX package's FloatModel of [(kind, weight, bias, stride)]."""
    fm = FloatModel(input_shape=input_shape)
    for kind, w, b, stride in ops:
        if kind == "conv":
            fm.add(FConv(weight=w, bias=b, stride=stride))
        elif kind == "dense":
            fm.add(FDense(weight=w, bias=b))
        else:
            fm.add({"relu": FRelu, "maxpool": FMaxpool, "flatten": FFlatten}[kind]())
    return fm


def cnn_reference(name: str) -> dict:
    """One CNN case of `R.cnn_case`, proved and verified with the JAX package;
    the LeNet is quantized first (inference observer, both inputs) and its
    first input proved, as bench.py's bench_cnn does."""
    if name == "lenet":
        ops, xs = R.cnn_case(name)
        model, s_in, _ = quantize(jax_float_model(R.LENET_TINY["input_shape"], ops), "inference", xs)
        x = Tensor(s_in.quantize(xs[0]).astype(np.int64))
    else:
        layers, x_np = R.cnn_case(name)
        model, x = jax_model(layers), Tensor(x_np)
    trace = model.run([x])
    ctx = Context.generate(model, **R.CNN_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec")).prove(trace)
    verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"))
    assert not proof.merges
    return {
        "input": R.plain(x.data),
        "output": R.plain(trace.outputs[0].data),
        "proof": {k: R.plain(getattr(proof, k)) for k in ("steps", "table_proofs", "shared_logup", "commit")},
    }


def jax_graph(case: dict) -> tuple:
    """The JAX package's Model and input Tensors of one `R.graph_case`."""
    from deepprove_tpu.zkml import llm
    from deepprove_tpu.zkml.float_model import FAdd
    from deepprove_tpu.zkml.layers.activation import Gelu
    from deepprove_tpu.zkml.layers.add import Add
    from deepprove_tpu.zkml.layers.concat_matmul import ConcatMatMul, Permute
    from deepprove_tpu.zkml.layers.logits import Logits
    from deepprove_tpu.zkml.layers.qkv import QKV
    from deepprove_tpu.zkml.layers.shape_ops import Reshape
    from deepprove_tpu.zkml.layers.softmax import Softmax
    from deepprove_tpu.zkml.layers.embeddings import Embeddings, Positional
    from deepprove_tpu.zkml.layers.layernorm import LayerNorm
    from deepprove_tpu.zkml.layers.matmul import MatMul
    from deepprove_tpu.zkml.layers.pad import Pad2D
    from deepprove_tpu.zkml import model as model_mod
    from deepprove_tpu.zkml.model import Edge

    if "gpt2" in case:
        _, model, x = R.gpt2_ffn_graph(llm, model_mod, Positional, case["gpt2"], case["seq"], case["tokens"],
                                       requant_bits=case.get("requant_bits"))
        return model, [Tensor(x)]
    if "float" in case:
        fm = FloatModel(input_shape=case["input_shape"])
        kinds = {"dense": FDense, "relu": FRelu, "add": FAdd}
        for kind, w, b, inputs in case["float"]:
            fm.add_node(kinds[kind](weight=w, bias=b) if kind == "dense" else kinds[kind](), inputs)
        model, s_in, _ = quantize(fm, "inference", case["cal"])
        return model, [Tensor(s_in.quantize(case["cal"][0]).astype(np.int64))]
    make = {
        "dense": lambda f: Dense(matrix=f["matrix"], bias=f["bias"]),
        "add": lambda f: Add(),
        "pad": lambda f: Pad2D(pad=f["pad"], input_shape=f["input_shape"]),
        "conv": lambda f: Convolution(filter=f["filter"], bias=f["bias"], input_shape=f["input_shape"],
                                      stride=f["stride"]),
        "matmul": lambda f: MatMul.new_constant(f["right"], f["bias"]) if "right" in f else MatMul(),
        "embeddings": lambda f: Embeddings(table=f["table"]),
        "positional": lambda f: Positional(table=f["table"]),
        "requant": lambda f: Requant(spec=RequantSpec.from_multiplier(f["multiplier"], f["bits"])),
        "gelu": lambda f: Gelu(s_in=f["s_in"], s_out=f["s_out"]),
        "layernorm": lambda f: LayerNorm.from_float(f["gamma_f"], f["beta_f"], eps=f["eps"], s_in=f["s_in"]),
        "qkv": lambda f: QKV(ws=list(f["ws"]), bs=list(f["bs"])),
        "permute": lambda f: Permute(tuple(f["perm"]), tuple(f["in_shape"])),
        "concat_matmul": lambda f: ConcatMatMul(transpose_b=f["transpose_b"]),
        "softmax": lambda f: Softmax(s_in=f["s_in"], max_size=f["max_size"], temperature=f["temperature"],
                                     seq=f["seq"], domain_max=f["domain_max"]),
        "reshape": lambda f: Reshape(tuple(f["shape"])),
        "logits": lambda f: Logits(),
    }
    model = Model(num_inputs=len(case["inputs"]))
    for kind, fields, edges in case["nodes"]:
        model.add_node(make[kind](fields), [Edge(node=n, index=i) for n, i in edges])
    return model, [Tensor(x) for x in case["inputs"]]


def graph_reference(name: str, kw: dict) -> dict:
    """One residual or transformer case of `R.graph_case`, proved and
    verified with the JAX package; its proof with its fan-out merges."""
    model, xs = jax_graph(R.graph_case(name))
    trace = model.run(xs)
    ctx = Context.generate(model, **kw)
    proof = Prover(ctx, BasicTranscript(b"m2vec")).prove(trace)
    verify(ctx, proof, IO(xs, trace.outputs), BasicTranscript(b"m2vec"))
    return {
        "inputs": [R.plain(x.data) for x in xs],
        "output": R.plain(trace.outputs[0].data),
        "proof": {k: R.plain(getattr(proof, k)) for k in R.GRAPH_PROOF_PARTS},
    }


PARTS = {
    "sumcheck": sumcheck_reference,
    "basefold": lambda: {name: basefold_reference(name) for name in ("rs", "trivial", "batch")},
    "dense": dense_reference,
    "logup": lambda: {name: logup_reference(name) for name in R.LOGUP_CASES},
    "mlp": mlp_reference,
    "cnn": lambda: {name: cnn_reference(name) for name in R.CNN_CASES},
    "residual": lambda: {name: graph_reference(name, R.RESIDUAL_KW) for name in R.RESIDUAL_CASES},
    "transformer": lambda: {name: graph_reference(name, R.TRANSFORMER_KW) for name in R.TRANSFORMER_CASES},
    "attention": lambda: {name: graph_reference(name, R.ATTENTION_KW) for name in R.ATTENTION_FROZEN},
    # the tiny GPT-2 graph, not in the frozen file (hours of XLA compiles)
    "gpt2_ffn": lambda: graph_reference(R.GPT2_CASE, R.TRANSFORMER_KW),
}


def generate(parts=tuple(PARTS)) -> dict:
    return {name: PARTS[name]() for name in parts}


if __name__ == "__main__":
    parts = sys.argv[1:] or list(PARTS)
    ref = R.load() if sys.argv[1:] else {}
    ref.update(generate(parts))
    with open(R.REFERENCE_PATH, "w") as f:
        json.dump(ref, f, separators=(",", ":"))
    print(f"wrote {R.REFERENCE_PATH} ({os.path.getsize(R.REFERENCE_PATH)} bytes)")
