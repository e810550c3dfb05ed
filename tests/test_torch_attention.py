"""The port's attention half on the CPU, held against the JAX package: QKV,
ConcatMatMul (plain and transpose_b), Permute, Softmax (causal, with a
zero chunk), Logits and `attn_fanout` (the attention half's claim flow:
QKV -> Softmax -> ConcatMatMul -> Permute -> Reshape -> Requant -> MatMul
-> the residual Add's fan-out; torch_reference.py ATTENTION_FROZEN)
proved once each, every proof equal to the JAX one frozen in
torch_reference.json (part `attention`) field for field, verified, and a
changed output rejected; `attn_block` (the GPT-2 attention half's
structure at width 16, LayerNorm and Logits included), whose JAX CPU
prove did not finish, proved and verified by the port and its layers
held live; every case's node outputs, the softmax
parameters, the point rewiring and the mask's closed form live against
the JAX package. Then the pieces the
width 768 needs: the tables built and counted on the device against the
JAX package's host loop, the clamping column's closed form against its
full MLE, rows of their own lengths in the sumcheck against their
tiling, the untiled batch opening of three sizes against the frozen JAX
proof, and a Merkle tree that keeps only its upper levels. Tolerance:
exact equality."""

import copy

import numpy as np
import pytest
import torch

import torch_reference as R
from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.pcs import basefold, merkle
from deepprove_tpu_torch.sumcheck import VirtualPolynomial, prover
from deepprove_tpu_torch.transcript import BasicTranscript
from deepprove_tpu_torch.transcript.session import DeviceTranscript
from deepprove_tpu_torch.zkml import lookup_context as LC
from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
from deepprove_tpu_torch.zkml.layers import concat_matmul, softmax
from deepprove_tpu_torch.zkml.tensor import Tensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    # these proves are thousands of small int64 ops: one thread is fastest
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref():
    return R.load()


def _inputs(xs):
    return [Tensor(torch.from_numpy(np.asarray(x, dtype=np.int64))) for x in xs]


@pytest.mark.parametrize("name", R.ATTENTION_FROZEN)
def test_attention_case_equals_frozen_jax_proof(ref, name):
    model, xs = R.port_graph(R.graph_case(name), "cpu")
    xs = _inputs(xs)
    trace = model.run(xs, device="cpu")
    frozen = ref["attention"][name]
    assert R.plain(trace.outputs[0].data.numpy()) == frozen["output"]
    ctx = Context.generate(model, device="cpu", **R.ATTENTION_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec"), device="cpu").prove(trace)
    assert {p: R.plain(getattr(proof, p)) for p in R.GRAPH_PROOF_PARTS} == frozen["proof"]
    verify(ctx, proof, IO(xs, trace.outputs), BasicTranscript(b"m2vec"), device="cpu")
    bad = [Tensor(t.data.clone()) for t in trace.outputs]
    bad[0].data.view(-1)[0] += 1
    with pytest.raises(AssertionError):
        verify(ctx, proof, IO(xs, bad), BasicTranscript(b"m2vec"), device="cpu")


def test_attn_block_proof_verifies_and_rejects_a_changed_output():
    """attn_block, whose JAX proof is not frozen: the port's verifier
    accepts its proof, with its fan-out merged, and rejects a changed
    output."""
    model, xs = R.port_graph(R.graph_case("attn_block"), "cpu")
    xs = _inputs(xs)
    trace = model.run(xs, device="cpu")
    ctx = Context.generate(model, device="cpu", **R.ATTENTION_KW)
    proof = Prover(ctx, BasicTranscript(b"m2vec"), device="cpu").prove(trace)
    assert proof.merges
    verify(ctx, proof, IO(xs, trace.outputs), BasicTranscript(b"m2vec"), device="cpu")
    bad = trace.outputs[0].data.clone()
    bad[0] = (bad[0] + 1) % 16
    with pytest.raises(AssertionError):
        verify(ctx, proof, IO(xs, [Tensor(bad)]), BasicTranscript(b"m2vec"), device="cpu")


def test_attn_fanout_layout(ref):
    """attn_fanout's frozen proof holds the attention half's claim flow:
    a step for each of its 16 nodes but the Reshape (not provable), its
    residual fan-out merged, and its four Requants' lookups in one
    consolidated logup of 20 instances beside the softmax's."""
    frozen = ref["attention"]["attn_fanout"]["proof"]
    kinds = [kind for kind, _, _ in R.graph_case("attn_fanout")["nodes"]]
    assert sorted(map(int, frozen["steps"])) == [i for i, k in enumerate(kinds) if k != "reshape"]
    assert len(kinds) == 16
    assert frozen["merges"]
    assert max(len(g["instances"]) for g in frozen["shared_logup"]) == 20


@pytest.mark.parametrize("name", R.ATTENTION_CASES)
def test_attention_case_layers_equal_jax(name):
    """Every node's outputs against the JAX package's model of the case."""
    import make_torch_reference as M

    case = R.graph_case(name)
    model, xs = R.port_graph(case, "cpu")
    trace = model.run(_inputs(xs), device="cpu")
    jmodel, jxs = M.jax_graph(case)
    jtrace = jmodel.run(jxs)
    for nid in model.forward_order():
        got, want = trace.steps[nid].outputs, jtrace.steps[nid].outputs
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))


def test_softmax_parameters_equal_jax():
    from deepprove_tpu.zkml.layers.softmax import Softmax as JSoftmax

    for kw in (dict(s_in=1 / 32, max_size=64, seq=8), dict(s_in=1 / 32, max_size=64, domain_max=4000),
               dict(R.ATTN_SOFTMAX), dict(s_in=3.1e-4, max_size=64, temperature=0.125, seq=64, domain_max=40000)):
        ours, theirs = softmax.Softmax(**kw), JSoftmax(**kw)
        for f in ("scalar", "bkm", "sts", "n_zero_chunks", "ztv", "neg_inf", "inv_temp", "error_bound"):
            assert getattr(ours, f) == getattr(theirs, f), (kw, f)
        assert (ours.exp_table.params, ours.error_table.params) == (theirs.exp_table.params,
                                                                    theirs.error_table.params)


def test_permute_rewiring_and_mask_equal_jax():
    from deepprove_tpu.zkml.layers import concat_matmul as jcm
    from deepprove_tpu.zkml.layers import softmax as jsm

    rng = np.random.default_rng(154)
    for perm, shape in (((1, 0, 2), (4, 2, 8)), ((2, 0, 1), (2, 4, 8)), ((0, 2, 1), (8, 2, 4))):
        pt = [R._ext(rng) for _ in range(6)]
        out_shape = tuple(shape[a] for a in perm)
        want = jcm._rewire_point_host(pt, perm, shape, out_shape)
        assert concat_matmul.rewire_point(pt, perm, shape) == want
        dev = concat_matmul.rewire_point(gf.ext_from_pairs(pt, "cpu"), perm, shape)
        assert gf.ext_to_pairs(dev) == want
    for seq, channels in ((4, 1), (8, 2), (8, 4), (6, 2)):
        k = max(0, (seq - 1).bit_length())
        n = k + (seq * channels - 1).bit_length()
        pt = [R._ext(rng) for _ in range(n)]
        direct = host.mle_eval_v(gf.to_u64(softmax.tril_mask(seq, 1 << (n - k), 1 << k).reshape(-1)), pt)
        assert softmax.tril_eval(seq, k, n, pt) == direct == jsm._tril_eval(seq, k, n, pt)


@pytest.mark.parametrize("size", range(4, 13))
def test_clamping_column_closed_form_equals_full_mle(size):
    rng = np.random.default_rng(155 + size)
    pt = [R._ext(rng) for _ in range(size)]
    _, cols = LC.TableType("clamping", (size,)).table_columns()
    assert LC.clamping_out_eval(size, pt) == host.mle_eval_v(gf.to_u64(cols[1]), pt)


def _host_multiplicities(merged: np.ndarray, values: np.ndarray) -> list:
    """The JAX package's host rule (zkml/lookup_context.py
    generate_lookup_witnesses): a table padded to a power of two by
    repeating rows, every row holding a value given its count, divided in
    the field by the value's repetitions where the table was padded."""
    n = merged.size
    np2 = 1 << max(0, (n - 1).bit_length())
    merged = merged[np.arange(np2) % n]
    counts = {}
    for v in values.tolist():
        counts[v] = counts.get(v, 0) + 1
    occ = {}
    for v in merged.tolist():
        occ[v] = occ.get(v, 0) + 1
    p = host.P
    out = []
    for v in merged.tolist():
        c = counts.get(v, 0)
        out.append(c * pow(occ[v], p - 2, p) % p if np2 != n and c else c)
    return out


class _SixRows:
    """A table of six rows with a repeated value: padded to 8 by repeating."""

    def name(self):
        return "six"

    def table_columns(self, device="cpu"):
        vals = self.merged_column(device)
        return vals.clone(), [vals]

    def merged_column(self, device="cpu"):
        return torch.tensor([10, 11, 12, 13, 10, 15], dtype=torch.int64, device=device)

    def row_offset(self):
        return None


TABLES = {
    "relu": LC.TableType("relu"), "range": LC.TableType("range"), "clamping": LC.TableType("clamping", (9,)),
    "gelu": LC.gelu_table_type(1 / 64, 1 / 32), "inv_sqrt": LC.TableType.inv_sqrt(1e-5, 9),
    "softmax": LC.TableType.softmax(2.0, 11, 110476260), "error": LC.TableType.error(4096, 734),
    "zero": LC.TableType("zero", (5,)), "padded": _SixRows(),
}


@pytest.mark.parametrize("kind", list(TABLES))
def test_device_counts_equal_host_built_multiplicities(kind):
    tt = TABLES[kind]
    merged, _ = tt.table_columns()
    rng = np.random.default_rng(156 + len(kind))
    rows = rng.integers(0, merged.shape[0], size=300)
    values = merged[torch.from_numpy(rows)]
    if kind == "error":  # the zero rows of the padding are one value many times
        values = torch.cat([values, torch.zeros(5, dtype=torch.int64)])
    got = gf.to_u64(LC.count_lookups(tt, values, "cpu")).tolist()
    assert got == _host_multiplicities(merged.numpy(), values.numpy())
    with pytest.raises(AssertionError, match="not in table"):
        LC.count_lookups(tt, torch.tensor([int(merged.max()) + (1 << 33)]), "cpu")


@pytest.mark.parametrize("case", list(R.SUMCHECK_RAGGED_CASES))
def test_rows_of_their_own_length_equal_their_tiling(case):
    """The per-round prover on rows at their own lengths against the same
    rows tiled to 2^n: messages, challenges, final evaluations."""
    n, m, products, degree, _, row_vars = R.SUMCHECK_RAGGED_CASES[case]
    rng = np.random.default_rng(157)
    rows = [rng.integers(0, host.P, size=(2, 1 << lg), dtype=np.uint64) for lg in row_vars]
    coeffs = [R._ext(rng) for _ in products]

    def run(tile):
        vp = VirtualPolynomial.new(n)
        for r in rows:
            reps = (1 << n) // r.shape[1] if tile else 1
            vp.add_mle(gf.GF2(gf.from_u64(np.tile(r[0], reps)), gf.from_u64(np.tile(r[1], reps))))
        for c, f in zip(coeffs, products):
            vp.add_product(c, f)
        out = prover.prove_device(vp, DeviceTranscript.from_host(BasicTranscript(b"ragged"), "cpu"))
        return [gf.ext_to_pairs(x.reshape(-1)) for x in (out.proof.round_messages, out.proof.point, out.final_evals)]

    assert run(False) == run(True)


def test_untiled_batch_opening_equals_frozen_jax(ref):
    polys, points = R.basefold_batch_inputs()
    params = basefold.setup(max(R.BASEFOLD_BATCH_LOGS), **R.BASEFOLD_KW)
    comms = basefold.commit_many(params, [gf.from_u64(p) for p in polys])
    evals = [basefold.BatchEvaluation(poly=i, point=i, value=host.mle_eval_v(p, pt))
             for i, (p, pt) in enumerate(zip(polys, points))]
    proof = basefold.batch_open(params, [gf.from_u64(p) for p in polys], comms, points, evals,
                                BasicTranscript(R.BASEFOLD_LABEL))
    frozen = ref["basefold"]["batch"]
    assert [list(c.commitment.root) for c in comms] == frozen["roots"]
    assert R.plain(proof) == frozen["proof"]
    basefold.batch_verify(params, [c.commitment for c in comms], points, evals, proof,
                          BasicTranscript(R.BASEFOLD_LABEL), device="cpu")
    bad = copy.deepcopy(evals)
    bad[2].value = host.ext_add(bad[2].value, (1, 0))
    with pytest.raises(AssertionError):
        basefold.batch_verify(params, [c.commitment for c in comms], points, bad, proof,
                              BasicTranscript(R.BASEFOLD_LABEL), device="cpu")


@pytest.mark.parametrize("ext", [False, True])
def test_merkle_tree_keeps_upper_levels_only(monkeypatch, ext):
    """A tree that drops its wide levels gives the root and paths of the
    whole tree, rebuilding each queried pair's subtree from the leaves."""
    rng = np.random.default_rng(158)
    leaves = gf.from_u64(rng.integers(0, host.P, size=256, dtype=np.uint64))
    if ext:
        leaves = gf.GF2(leaves, gf.from_u64(rng.integers(0, host.P, size=256, dtype=np.uint64)))
    whole = merkle.MerkleTree.from_leaves(leaves)  # 128 pairs: at most 2^WHOLE_LOG
    monkeypatch.setattr(merkle, "WHOLE_LOG", 6)
    monkeypatch.setattr(merkle, "KEEP_LOG", 3)
    upper = merkle.MerkleTree.from_leaves(leaves)
    assert (upper.dropped, len(upper.levels), whole.dropped) == (4, 4, 0)
    assert upper.root == whole.root and upper.depth == whole.depth
    idx = torch.tensor([0, 1, 17, 64, 127, 17])
    assert torch.equal(upper.paths_dev(idx), whole.paths_dev(idx))
