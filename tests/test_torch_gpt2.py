"""The port's whole GPT-2 graph (`GPT2Builder.build`: Embeddings to Logits)
and its generation loop (`Driver`) on the CPU, held against the JAX
package live: the tiny config of tests/test_llm.py gives the same graph,
Requant specs, quantized weights, every node's output and generated
tokens; GPT-2-124M's graph at two blocks (built, not run) the same node
kinds and clamping tables; the chip phase's numpy evaluation equals the
port's inference. The port proves the tiny graph (its Requants' bits
fitted to their inputs, so that its tables stay small) and its verifier
accepts the proof and rejects a changed output. No JAX prove: the JAX
package's GPT-2 prove is gated behind ZKML_RUN_LLM_TESTS (40+ minutes of
XLA compiles). Tolerance: exact equality."""

import dataclasses

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.zkml import llm
from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
from deepprove_tpu_torch.zkml.tensor import Tensor

TINY = dict(vocab=32, emb=16, heads=2, blocks=1, context=8)  # tests/test_llm.py:30-36
TINY_SEQ, TINY_TOKENS = 4, np.array([3, 7, 1, 5], dtype=np.int64)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny():
    """(port model, meta, JAX model, JAX meta) of the tiny config."""
    from deepprove_tpu.zkml import llm as jllm

    model, meta = llm.GPT2Builder(llm.GPT2Weights.synthetic(llm.LLMConfig(**TINY), seed=0), TINY_SEQ,
                                  device="cpu").build(TINY_TOKENS)
    jmodel, jmeta = jllm.GPT2Builder(jllm.GPT2Weights.synthetic(jllm.LLMConfig(**TINY), seed=0),
                                     TINY_SEQ).build(TINY_TOKENS)
    return model, meta, jmodel, jmeta


def _arr(t):
    return np.asarray(t.cpu() if hasattr(t, "cpu") else t)


def test_tiny_graph_and_weights_equal_jax(tiny):
    model, meta, jmodel, jmeta = tiny
    assert meta["s_logits"] == jmeta["s_logits"] and meta["seq"] == jmeta["seq"]
    assert list(model.nodes) == list(jmodel.nodes)
    for nid in model.forward_order():
        op, jop = model.nodes[nid].op, jmodel.nodes[nid].op
        assert type(op).__name__ == type(jop).__name__, nid
        assert [(e.node, e.index) for e in model.nodes[nid].inputs] == [
            (e.node, e.index) for e in jmodel.nodes[nid].inputs]
        if hasattr(op, "spec"):
            assert dataclasses.asdict(op.spec) == dataclasses.asdict(jop.spec)
        for f in ("table", "right_const", "bias", "gamma", "beta"):
            if getattr(jop, f, None) is not None:
                np.testing.assert_array_equal(_arr(getattr(op, f)), _arr(getattr(jop, f)))
        for f in ("ws", "bs"):
            for a, b in zip(getattr(op, f, []), getattr(jop, f, [])):
                np.testing.assert_array_equal(_arr(a), _arr(b))
        for f in ("perm", "in_shape", "transpose_b", "shape", "scalar", "sts", "ztv", "n_zero_chunks", "neg_inf",
                  "bkm", "seq", "dim_size", "multiplier", "eps", "range_check_bits", "s_in", "s_out"):
            if hasattr(jop, f):
                assert getattr(op, f) == getattr(jop, f), (nid, f)


def test_tiny_inference_and_generation_equal_jax(tiny):
    from deepprove_tpu.zkml import llm as jllm
    from deepprove_tpu.zkml.tensor import Tensor as JTensor

    model, meta, jmodel, jmeta = tiny
    trace = model.run([Tensor(torch.from_numpy(TINY_TOKENS))], device="cpu")
    jtrace = jmodel.run([JTensor(TINY_TOKENS)])
    for nid in model.forward_order():
        for g, w in zip(trace.steps[nid].outputs, jtrace.steps[nid].outputs, strict=True):
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data), err_msg=str(nid))
    # the chip phase's numpy evaluation of the same quantized graph
    np.testing.assert_array_equal(R.numpy_eval_graph(R.graph_records(model), [TINY_TOKENS]),
                                  trace.outputs[0].data.numpy())
    tokens, steps = llm.Driver(model, meta).generate([3, 7], n_tokens=2)
    jtokens, _ = jllm.Driver(jmodel, jmeta).generate([3, 7], n_tokens=2)
    assert tokens == jtokens and len(steps) == 2


def test_gpt2_124m_two_blocks_graph_equals_jax():
    """GPT-2-124M's graph cut to the chip phase's two blocks, built only:
    the node kinds, every Requant's spec and the clamping tables (2^28 rows
    the largest, shared by three Requants)."""
    from deepprove_tpu.zkml import llm as jllm

    cfg, seq = R.GPT2_CHIP, R.GPT2_124M_SEQ
    prompt = np.random.default_rng(0).integers(0, cfg["vocab"], size=seq // 2).astype(np.int64)
    model, _ = llm.GPT2Builder(llm.GPT2Weights.synthetic(llm.LLMConfig(**cfg), seed=0), seq,
                               device="cpu").build(prompt)
    jmodel, _ = jllm.GPT2Builder(jllm.GPT2Weights.synthetic(jllm.LLMConfig(**cfg), seed=0), seq).build(prompt)
    kinds = [type(model.nodes[n].op).__name__ for n in model.forward_order()]
    assert kinds == [type(jmodel.nodes[n].op).__name__ for n in jmodel.forward_order()]
    specs = [model.nodes[n].op.spec for n in model.forward_order() if kinds[n] == "Requant"]
    jspecs = [jmodel.nodes[n].op.spec for n in jmodel.forward_order() if kinds[n] == "Requant"]
    assert [dataclasses.asdict(s) for s in specs] == [dataclasses.asdict(s) for s in jspecs]
    sizes = [s.clamping_size() for s in specs]
    assert sorted(set(sizes)) == [3, 10, 15, 16, 17, 18, 20, 22, 23, 24, 27, 28] and sizes.count(28) == 3


def _fit_requants(model, trace):
    """Each Requant's bits fitted to its input (|largest| bit length + 1),
    its multiplier kept: the same outputs, clamping tables of 2^12 rows at
    most instead of up to 2^19."""
    for nid in model.forward_order():
        op = model.nodes[nid].op
        if isinstance(op, llm.Requant):
            bits = int(trace.steps[nid].inputs[0].data.abs().max()).bit_length() + 1
            model.nodes[nid].op = llm.Requant(spec=llm.RequantSpec.from_multiplier(op.spec.multiplier, bits))


def test_tiny_gpt2_proof_verifies_and_rejects_a_changed_output(tiny):
    model, meta = llm.GPT2Builder(llm.GPT2Weights.synthetic(llm.LLMConfig(**TINY), seed=0), TINY_SEQ,
                                  device="cpu").build(TINY_TOKENS)
    x = Tensor(torch.from_numpy(TINY_TOKENS))
    _fit_requants(model, model.run([x], device="cpu"))
    ctx = Context.generate(model, device="cpu", num_queries=7, basecode_msg_size_log=2)
    step = llm.Driver(model, meta, ctx).step(TINY_TOKENS, prove=True)
    np.testing.assert_array_equal(step.trace.outputs[0].data.numpy(),
                                  tiny[0].run([x], device="cpu").outputs[0].data.numpy())
    assert step.proof.merges, "the residuals' fan-outs are merged"
    verify(ctx, step.proof, IO([x], step.trace.outputs), BasicTranscript(b"m2vec"), device="cpu")
    bad = step.trace.outputs[0].data.clone()
    bad[-1] = (bad[-1] + 1) % 32
    with pytest.raises(AssertionError):
        verify(ctx, step.proof, IO([x], [Tensor(bad)]), BasicTranscript(b"m2vec"), device="cpu")
