"""The port's transformer first half on the CPU, held against the JAX
package: MatMul (two witness inputs; constant with bias), Gelu, LayerNorm,
Embeddings/Positional, the gelu and inv_sqrt tables, and the tiny GPT-2
graph of the chip phase `gpt2_ffn` (Positional, then the feed-forward
halves of blocks 0 and 1, whose two residuals fan out). The cases of
torch_reference.py `TRANSFORMER_CASES` and the GPT-2 graph with its
Requants' bits fitted to their inputs (`gpt2_ffn_fit`) are proved once
each; every case's proof must equal the JAX one frozen in
torch_reference.json (part `transformer`) field for field, merges
included (the GPT-2 graph's is not frozen; `ffn_fanouts` holds its
structure: see torch_reference.py); the port's verifier accepts each
proof and rejects a changed output and wrong tokens. The inference (every node's output), the
tables' rows, `_calibrate`, `_q`, LayerNorm's witness rows and the Requant
specs are compared with the JAX package live, for the GPT-2 graph with the
builder's own bits (`gpt2_ffn`) too. Tolerance: exact equality."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.zkml import llm
from deepprove_tpu_torch.zkml import lookup_context as LC
from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
from deepprove_tpu_torch.zkml.tensor import Tensor

PROVED = R.TRANSFORMER_CASES + (R.GPT2_FIT_CASE,)
BUILT = PROVED + (R.GPT2_CASE,)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # these proves are thousands of small int64 ops: one thread is fastest,
    # and many threads thrash when other test processes share the cores
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def built():
    out = {}
    for name in BUILT:
        model, xs = R.port_graph(R.graph_case(name), "cpu")
        xs = [Tensor(torch.from_numpy(np.asarray(x, dtype=np.int64))) for x in xs]
        out[name] = (model, xs, model.run(xs, device="cpu"))
    return out


@pytest.fixture(scope="module")
def proved(built):
    out = {}
    for name in PROVED:
        model, xs, trace = built[name]
        ctx = Context.generate(model, device="cpu", **R.TRANSFORMER_KW)
        proof = Prover(ctx, BasicTranscript(b"m2vec"), device="cpu").prove(trace)
        out[name] = (model, xs, trace, ctx, proof)
    return out


def _verify(ctx, proof, xs, outputs):
    verify(ctx, proof, IO(xs, outputs), BasicTranscript(b"m2vec"), device="cpu")


@pytest.mark.parametrize("name", BUILT)
def test_inference_equals_jax(built, name):
    import make_torch_reference as M

    model, xs, trace = built[name]
    jmodel, jxs = M.jax_graph(R.graph_case(name))
    assert [x.data.tolist() for x in xs] == [np.asarray(x.data).tolist() for x in jxs]
    jtrace = jmodel.run(jxs)
    for nid in model.forward_order():  # every node's output, not only the last
        got = trace.steps[nid].outputs[0].data.tolist()
        assert got == np.asarray(jtrace.steps[nid].outputs[0].data).tolist(), nid
    if name in R.TRANSFORMER_CASES:
        ref = R.load()["transformer"][name]
        assert [x.data.tolist() for x in xs] == ref["inputs"]
        assert trace.outputs[0].data.tolist() == ref["output"]


@pytest.mark.parametrize("name", R.TRANSFORMER_CASES)
def test_proof_equals_jax_proof(proved, name):
    *_, proof = proved[name]
    ref = R.load()["transformer"][name]["proof"]
    for part in R.GRAPH_PROOF_PARTS:
        assert R.plain(getattr(proof, part)) == ref[part], part


@pytest.mark.parametrize("name", PROVED)
def test_verifier_accepts(proved, name):
    _, xs, trace, ctx, proof = proved[name]
    _verify(ctx, proof, xs, trace.outputs)


@pytest.mark.parametrize("name", PROVED)
def test_verifier_rejects_changed_output(proved, name):
    _, xs, trace, ctx, proof = proved[name]
    bad = trace.outputs[0].data.clone()
    bad.view(-1)[0] += 1
    with pytest.raises(AssertionError):
        _verify(ctx, proof, xs, [Tensor(bad)])


def test_embeddings_rejects_wrong_tokens(proved):
    _, (tokens,), trace, ctx, proof = proved["embeddings"]
    with pytest.raises(AssertionError):
        _verify(ctx, proof, [Tensor((tokens.data + 1) % 16)], trace.outputs)


@pytest.mark.parametrize("where", ["layernorm_io", "layernorm_provided", "layernorm_merge", "matmul_final"])
def test_verifier_rejects_tampered_proof(proved, where):
    name = "matmul_witness" if where == "matmul_final" else "layernorm"
    _, xs, trace, ctx, proof = proved[name]
    bad = copy.deepcopy(proof)
    step = bad.steps[0]
    if where == "layernorm_io":
        step.io_evals[2] = host.ext_add(step.io_evals[2], (1, 0))
    elif where == "layernorm_provided":
        step.provided_evals[1] = host.ext_add(step.provided_evals[1], (1, 0))
    elif where == "layernorm_merge":
        step.x_merge.evals[1] = host.ext_add(step.x_merge.evals[1], (1, 0))
    else:
        step.individual_claims[0] = host.ext_add(step.individual_claims[0], (1, 0))
    with pytest.raises(AssertionError):
        _verify(ctx, bad, xs, trace.outputs)


def test_ffn_fanouts_layout(proved):
    """The frozen case keeps the GPT-2 path's structure: two fan-outs
    merged in one backward walk, a LayerNorm into a Requant, all four table
    kinds, clamping tables of 2^8 rows."""
    model, _, _, ctx, proof = proved["ffn_fanouts"]
    assert list(proof.merges) == [(6, 0), (0, 0)]
    assert type(model.nodes[2].op).__name__ == "Requant" and model.nodes[2].inputs[0].node == 1
    assert {"gelu", "inv_sqrt", "range", "clamping"} == {t.kind for t in ctx.lookup}
    assert [t.params for t in ctx.lookup if t.kind == "clamping"] == [(8,)]


def test_gpt2_ffn_layout(proved):
    model, _, _, ctx, proof = proved[R.GPT2_FIT_CASE]
    ffn = ["LayerNorm", "Requant", "MatMul", "Requant", "Gelu", "MatMul", "Requant", "Add", "Requant"]
    assert [type(model.nodes[n].op).__name__ for n in model.forward_order()] == ["Positional"] + ffn * 2
    # both residual wires fan out: the positional output and block 0's last requant
    assert list(proof.merges) == [(9, 0), (0, 0)]
    kinds = [t.kind for t in ctx.lookup]
    assert {"gelu", "inv_sqrt", "range", "clamping"} == set(kinds)
    assert set(ctx.commitment_ctx.table_comms) == {t for t in ctx.lookup if t.kind in ("gelu", "inv_sqrt")}


def test_tables_equal_jax():
    from deepprove_tpu.transcript import BasicTranscript as JaxTranscript
    from deepprove_tpu.zkml import lookup_context as JLC

    types = [LC.gelu_table_type(1 / 64, 1 / 32), LC.TableType.inv_sqrt(256 * 1e-5, 17), LC.TableType("range"),
             LC.gelu_table_type(0.0123, 0.0456), LC.TableType.inv_sqrt(1e-5, 9), LC.TableType("clamping", (9,))]
    jtypes = [JLC.TableType(t.kind, t.params) for t in types]
    assert [t.params for t in types[:2]] == [JLC.gelu_table_type(1 / 64, 1 / 32).params,
                                             JLC.TableType.inv_sqrt(256 * 1e-5, 17).params]
    assert [t.name() for t in sorted(types)] == [t.name() for t in sorted(jtypes)]
    rng = np.random.default_rng(150)
    for t, jt in zip(types, jtypes):
        merged, cols = t.table_columns()
        j_merged, j_cols = jt.table_columns()
        np.testing.assert_array_equal(merged.numpy(), j_merged)
        assert [gf.to_u64(c).tolist() for c in cols] == [np.asarray(c).tolist() for c in j_cols]
        assert (t.multiplicity_poly_vars(), t.num_columns()) == (jt.multiplicity_poly_vars(), jt.num_columns())
        pt = [R._ext(rng) for _ in range(t.multiplicity_poly_vars())]
        assert t.evaluate_table_columns(pt) == jt.evaluate_table_columns(pt)
        assert t.evaluate_table_columns(pt) == [host.mle_eval_v(gf.to_u64(c), pt) for c in cols][
            : len(t.evaluate_table_columns(pt))]
        claims = [object(), object(), object()]
        assert t.table_claims(claims) == jt.table_claims(claims)
        jc, c = jt.committed_columns(), t.committed_columns("cpu")
        assert (c is None) == (jc is None)
        if c is not None:  # the output column, committed at setup
            assert gf.to_u64(c).tolist() == np.asarray(j_cols[1]).tolist()
    np.testing.assert_array_equal(LC.gelu_rows(types[0].params)[1], JLC._gelu_rows(types[0].params)[1])
    np.testing.assert_array_equal(LC.inv_sqrt_rows(types[1].params)[1], JLC._inv_sqrt_rows(types[1].params)[1])
    ours = LC.ChallengeStorage.initialise(types, BasicTranscript(b"tbl"))
    theirs = JLC.ChallengeStorage.initialise(jtypes, JaxTranscript(b"tbl"))
    assert (ours.constant_challenge, ours.challenge_map) == (theirs.constant_challenge, theirs.challenge_map)


@pytest.mark.parametrize("kind", ["softmax", "error", "zero"])
def test_attention_tables_raise_naming_the_next_slice(kind):
    """The attention slice's tables, once raising here, now equal the JAX
    package's: name, columns, closed forms, committed column, challenge."""
    from deepprove_tpu.transcript import BasicTranscript as JaxTranscript
    from deepprove_tpu.zkml import lookup_context as JLC

    t = {"softmax": LC.TableType.softmax(1 / 0.35, 12, 312474050), "error": LC.TableType.error(4096, 368),
         "zero": LC.TableType("zero", (5,))}[kind]
    jt = JLC.TableType(t.kind, t.params)
    assert t.name() == jt.name()
    merged, cols = t.table_columns()
    j_merged, j_cols = jt.table_columns()
    np.testing.assert_array_equal(merged.numpy(), j_merged)
    assert [gf.to_u64(c).tolist() for c in cols] == [np.asarray(c).tolist() for c in j_cols]
    assert (t.multiplicity_poly_vars(), t.num_columns()) == (jt.multiplicity_poly_vars(), jt.num_columns())
    pt = [R._ext(np.random.default_rng(153)) for _ in range(t.multiplicity_poly_vars())]
    assert t.evaluate_table_columns(pt) == jt.evaluate_table_columns(pt)
    claims = [object(), object(), object()]
    assert t.table_claims(claims) == jt.table_claims(claims)
    jc, c = jt.committed_columns(), t.committed_columns("cpu")
    assert (c is None) == (jc is None)
    if c is not None:
        assert gf.to_u64(c).tolist() == np.asarray(j_cols[-1]).tolist()
    assert t.generate_challenge(BasicTranscript(b"c")) == jt.generate_challenge(JaxTranscript(b"c"))



def test_llm_host_functions_equal_jax():
    from deepprove_tpu.zkml import llm as jllm

    cfg = R.GPT2_TINY
    w, jw = llm.GPT2Weights.synthetic(llm.LLMConfig(**cfg)), jllm.GPT2Weights.synthetic(jllm.LLMConfig(**cfg))
    for f in ("wte", "wpe", "lnf_g", "lnf_b", "lm_head"):
        np.testing.assert_array_equal(getattr(w, f), getattr(jw, f))
    for blk, jblk in zip(w.blocks, jw.blocks):
        for f in dataclasses.fields(blk):
            np.testing.assert_array_equal(getattr(blk, f.name), getattr(jblk, f.name))
    toks = np.array(R.GPT2_TINY_TOKENS)
    sc = llm.GPT2Builder(w, R.GPT2_TINY_SEQ, device="cpu")._calibrate(toks)
    assert sc == jllm.GPT2Builder(jw, R.GPT2_TINY_SEQ)._calibrate(toks)
    s = llm._mx(w.wte) / 127
    np.testing.assert_array_equal(llm._q(w.wte, s), jllm._q(jw.wte, s))
    assert llm._ln_out_scale(w.blocks[0].ln2_g, s) == jllm._ln_out_scale(jw.blocks[0].ln2_g, s)


def test_gpt2_graph_layers_equal_jax(built):
    """Every layer of the tiny GPT-2 graph against the JAX builder's: the
    Requant specs, LayerNorm's quantized parameters and witness rows, the
    MatMul weights and biases, the Gelu scales, the positional table."""
    import make_torch_reference as M

    model, xs, trace = built[R.GPT2_CASE]
    jmodel, _ = M.jax_graph(R.graph_case(R.GPT2_CASE))
    for nid in model.forward_order():
        op, jop = model.nodes[nid].op, jmodel.nodes[nid].op
        assert [(e.node, e.index) for e in model.nodes[nid].inputs] == [
            (e.node, e.index) for e in jmodel.nodes[nid].inputs]
        if hasattr(op, "spec"):
            assert dataclasses.asdict(op.spec) == dataclasses.asdict(jop.spec)
        for f in ("gamma", "beta", "right_const", "bias", "table"):
            if hasattr(jop, f):
                np.testing.assert_array_equal(getattr(op, f).numpy(), np.asarray(getattr(jop, f)))
        for f in ("dim_size", "multiplier", "eps", "range_check_bits", "n_chunks", "top_chunk_scalar_log", "s_in",
                  "s_out"):
            if hasattr(jop, f):
                assert getattr(op, f) == getattr(jop, f), f
        if type(op).__name__ == "LayerNorm":
            x = op._pad_input(trace.steps[nid].inputs[0].data)
            got = op._rows(x)
            want = jop._rows(jop._pad_input(np.asarray(x.numpy())))
            for g, wv in zip(got, want):
                np.testing.assert_array_equal(g.numpy(), wv)


def test_scatter_tokens_and_selection_equal_jax():
    import jax.numpy as jnp
    from deepprove_tpu.fields import gf as jgf
    from deepprove_tpu.zkml.layers import embeddings as jemb
    from deepprove_tpu_torch.zkml.layers import embeddings as emb

    rng = np.random.default_rng(151)
    tokens = rng.integers(0, 8, size=6)
    tokens[:3] = 5  # repeated tokens sum in the field
    eq = [R._ext(rng) for _ in range(8)]
    got = emb.scatter_tokens(gf.ext_from_pairs(eq, "cpu"), torch.from_numpy(tokens), 16)
    jeq = jgf.ext_from_u64(jnp.asarray([a for a, _ in eq], dtype=jnp.uint64),
                           jnp.asarray([b for _, b in eq], dtype=jnp.uint64))
    a0, a1 = jgf.ext_to_u64(jemb._scatter_tokens_kernel(jeq, jnp.asarray(tokens, dtype=jnp.int32), 16))
    assert gf.ext_to_pairs(got) == list(zip(np.asarray(a0).tolist(), np.asarray(a1).tolist()))
    r_t, s_v = [R._ext(rng) for _ in range(3)], [R._ext(rng) for _ in range(4)]
    assert emb.selection_eval(tokens.tolist(), r_t, s_v) == jemb._selection_eval(tokens, r_t, s_v)


def test_int_matmul_equals_numpy():
    from deepprove_tpu_torch.zkml.layers import matmul

    rng = np.random.default_rng(152)
    a, b = rng.integers(-1000, 1000, size=(37, 65)), rng.integers(-1000, 1000, size=(65, 19))
    saved = matmul._CHUNK_ELEMS
    matmul._CHUNK_ELEMS = 65 * 19 * 5  # chunks of 5 rows, the last one short
    try:
        np.testing.assert_array_equal(matmul.int_matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(), a @ b)
    finally:
        matmul._CHUNK_ELEMS = saved


@pytest.mark.parametrize("call", ["build", "_attention", "Driver", "from_gguf"])
def test_the_rest_of_gpt2_raises_naming_the_next_slice(call):
    """Of the calls that raised until the attention slice, only the GGUF
    loader still does, naming its later item; the others build."""
    from deepprove_tpu_torch.zkml.model import Model

    w = llm.GPT2Weights.synthetic(llm.LLMConfig(**R.GPT2_TINY))
    b = llm.GPT2Builder(w, R.GPT2_TINY_SEQ, device="cpu")
    if call == "from_gguf":
        with pytest.raises(NotImplementedError, match="GGUF"):
            llm.GPT2Weights.from_gguf(None)
    elif call == "build":
        model, meta = b.build(np.array(R.GPT2_TINY_TOKENS))
        assert type(model.nodes[max(model.nodes)].op).__name__ == "Logits" and meta["seq"] == R.GPT2_TINY_SEQ
    elif call == "_attention":
        m = Model()
        sc = b._calibrate(np.array(R.GPT2_TINY_TOKENS))
        last, _ = b._attention(m, m.add_node(llm.Requant(spec=llm.RequantSpec.from_multiplier(1.0, 9)),
                                             [llm.Edge(node=None, index=0)]), 1.0, w.blocks[0], 0, sc)
        assert type(m.nodes[last].op).__name__ == "Requant"
    else:
        assert llm.Driver(None, {"seq": 4, "device": "cpu"}).meta["seq"] == 4
