"""Inputs and frozen JAX-package outputs that the PyTorch port is held against.

Proving with the JAX package on the CPU takes minutes per call, far beyond
what the `tests/test_torch_*` files may spend, so `make_torch_reference.py`
proves once with the JAX package on the seeded numpy inputs below and
stores the results in `torch_reference.json`; the tests and `chip_smoke.py`
compare the port's outputs with them field for field, and
`test_torch_reference.py` (`-m jax_reference`) recomputes them with the
JAX package and checks the file is unchanged. This module imports
neither jax nor the JAX package, so `chip_smoke.py` can use it on a machine
without JAX.

The inputs and the normalisation of proofs into plain JSON are shared by
the generator and the tests, so both sides see exactly the same data.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np

REFERENCE_PATH = os.path.join(os.path.dirname(__file__), "torch_reference.json")

P = (1 << 64) - (1 << 32) + 1
Q_MIN, Q_MAX = -127, 127  # quantization range at the default BIT_LEN = 8

# sumcheck: sum_b a*b*c + (3 + 9X)*b over {0,1}^4, c an extension MLE
SUMCHECK_NUM_VARS = 4
SUMCHECK_LABEL = b"torch-port sumcheck"
SUMCHECK_PRODUCTS = [((1, 0), [0, 1, 2]), ((3, 9), [1])]

# The CUDA sumcheck kernels' edge shapes (chip_smoke.py and the `cuda`
# tests hold them against the per-round prover): name -> (num_vars, rows,
# products' factor lists, degree, tail start or None for fused.TAIL_LOG).
# One row; more products than a tail block has threads (512); each degree
# 1..5 with a product of lower degree; a tail from round 0 (no first fold);
# one variable; 37 rows, which divide over no block or grid (with a round
# above a tail from 10); a tail of one round that folds first.
SUMCHECK_EDGE_CASES = {
    "one_row": (8, 1, [[0, 0], [0]], 2, None),
    "600_products": (9, 3, [[i % 3, (i + 1) % 3] for i in range(600)], 2, None),
    **{f"degree_{d}": (9, 6, [list(range(d)), [5]], d, None) for d in range(1, 6)},
    "tail_from_round_0": (6, 4, [[0, 1], [2, 3]], 2, None),
    "one_variable": (1, 3, [[0, 1], [2]], 2, None),
    "37_rows": (11, 37, [[i, (i + 1) % 37] for i in range(37)], 2, 10),
    "tail_of_one_round": (5, 4, [[0, 1, 2], [3]], 3, 1),
}

# Rows of their own lengths (a row of 2^l entries stands for its tiling over
# the high variables; the batch opening's eq and merged rows of a claim on
# a smaller polynomial): name -> (num_vars, rows, products' factor lists,
# degree, tail start or None, each row's log-length). Rows of 2^11, 2 and 1
# beside full ones, folded above a tail from 10; three sizes and a constant
# row at degree 3, all in the tail; a row of 4 and one of 2^12 beside full
# ones above the tail; the batch opening's shape, an (eq, merged) product
# a claim at eight sizes from 2^16 down to 1, six rounds above a tail from
# 10; at degree 3 above the same tail, a row of 2^12 in a product of span
# 2^13 and in one of its own span, which mixes it with rows of 2^9 and
# 2^5, a row of 2^13 that no product lists and a constant row.
SUMCHECK_RAGGED_CASES = {
    "ragged_batch_open": (16, 8, [[0, 1], [2, 3], [4, 5], [6, 7]], 2, 10, [16, 16, 11, 11, 1, 1, 0, 0]),
    "ragged_three_sizes": (12, 6, [[0, 1, 2], [3, 4], [5, 1]], 3, None, [12, 7, 12, 3, 9, 0]),
    "ragged_above_tail": (13, 4, [[0, 1], [2, 3]], 2, 10, [13, 12, 2, 13]),
    "ragged_opening_eight_sizes": (16, 16, [[2 * c, 2 * c + 1] for c in range(8)], 2, 10,
                                   [lg for lg in (16, 15, 13, 11, 9, 6, 1, 0) for _ in range(2)]),
    "ragged_shared_mixed_alone": (14, 7, [[0, 1, 2], [1, 3, 4], [3, 6], [2, 2]], 3, 10,
                                  [14, 12, 14, 9, 5, 13, 0]),
}

# The batch opening of GPT-2-124M cut to two blocks (chip_smoke.py phase
# gpt2, its largest stacked sumcheck: 512 rows, 1,284,445,184 entries):
# claims by the log-length of their two rows (eq and merged), from the
# phase's `rows_by_log_length` on an H100.
GPT2_OPENING_CLAIMS = {28: 1, 27: 1, 26: 2, 24: 1, 23: 1, 22: 13, 20: 9, 18: 19, 17: 1, 16: 164, 15: 9, 14: 2,
                       12: 2, 10: 25, 8: 6}

# basefold: one 2^6 poly (RS path) and one 2^2 poly (trivial commitment)
BASEFOLD_KW = dict(num_queries=11, basecode_msg_size_log=2)
BASEFOLD_MAX_LOG = 6
BASEFOLD_LABEL = b"torch-port basefold"

# the Dense chain of the slice test
DENSE_DIMS = [16, 32, 8]
DENSE_KW = dict(num_queries=11, basecode_msg_size_log=2)

# the Dense -> Requant -> ReLU chain of the lookup slice test (bench.py's
# MLP at a small width): column sizes 16 and 4, three tables of 2^8 rows
MLP_DIMS = [4, 16, 16, 3]
MLP_KW = DENSE_KW
REQUANT_FIELDS = ("right_shift", "fixed_point_multiplier", "fp_scale", "multiplier", "intermediate_bit_size")

# the CNN slice, at the JAX tests' PCS sizes: (a) the conv -> requant ->
# maxpool -> flatten -> dense model of tests/test_zkml_conv.py:55-80, (b)
# the strided conv of :117-133, (c) a tiny LeNet-shaped float model
# quantized with the inference observer
CNN_KW = dict(num_queries=7, basecode_msg_size_log=2)
CNN_CASES = ("conv_pool_dense", "strided", "lenet")

# LeNet shapes: input, then (out channels, kernel) a conv (each followed by
# ReLU and a 2x2 maxpool), then the dense widths (ReLU between them);
# `flat_in` is the first dense layer's column count. LENET is the CIFAR-10
# classifier of PyTorch's "Training a classifier" tutorial (its first dense
# layer reads the 16 x 5 x 5 valid outputs, which `pad_pass` spreads over
# the padded 16 x 8 x 8 grid); LENET_TINY is case (c), whose dense layer
# reads the padded 4 x 2 x 2 grid directly.
LENET = dict(input_shape=(3, 32, 32), convs=((6, 5), (16, 5)), denses=(120, 84, 10), flat_in=400,
             pad_pass=True)
LENET_TINY = dict(input_shape=(3, 8, 8), convs=((4, 3), (4, 3)), denses=(8, 3), flat_in=16, pad_pass=False)

# logup-GKR cases on the inputs of tests/test_logup.py, at fixed seeds
LOGUP_CASES = ("single", "multi", "table", "grouped_lookups", "grouped_tables", "wrong_multiplicity")


def sumcheck_inputs():
    rng = np.random.default_rng(101)
    n = 1 << SUMCHECK_NUM_VARS
    a, b, c0, c1 = (rng.integers(0, P, size=n, dtype=np.uint64) for _ in range(4))
    return a, b, (c0, c1)


# the batch opening with polynomials of three sizes (2^6, 2^4, 2^3) at
# three points, which the sumcheck reads at their own lengths
BASEFOLD_BATCH_LOGS = (6, 4, 3)


def basefold_batch_inputs():
    """(polys, points): one random base poly and one point a size."""
    rng = np.random.default_rng(105)
    polys = [rng.integers(0, P, size=1 << n, dtype=np.uint64) for n in BASEFOLD_BATCH_LOGS]
    points = [[tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64)) for _ in range(n)]
              for n in BASEFOLD_BATCH_LOGS]
    return polys, points


def basefold_inputs():
    rng = np.random.default_rng(102)
    big = rng.integers(0, P, size=1 << BASEFOLD_MAX_LOG, dtype=np.uint64)
    small = rng.integers(0, P, size=4, dtype=np.uint64)

    def point(n):
        return [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64)) for _ in range(n)]

    return big, point(BASEFOLD_MAX_LOG), small, point(2)


def dense_inputs():
    """[(matrix, bias), ...] and the input vector x, int64 in [Q_MIN, Q_MAX]."""
    rng = np.random.default_rng(103)
    layers = []
    for i in range(len(DENSE_DIMS) - 1):
        w = rng.integers(Q_MIN, Q_MAX + 1, size=(DENSE_DIMS[i + 1], DENSE_DIMS[i]))
        b = rng.integers(Q_MIN, Q_MAX + 1, size=DENSE_DIMS[i + 1])
        layers.append((w.astype(np.int64), b.astype(np.int64)))
    x = rng.integers(Q_MIN, Q_MAX + 1, size=DENSE_DIMS[0]).astype(np.int64)
    return layers, x


def mlp_inputs():
    """bench.py's draw order (per layer matrix then bias, x last) at MLP_DIMS."""
    rng = np.random.default_rng(104)
    layers = []
    for i in range(len(MLP_DIMS) - 1):
        w = rng.integers(Q_MIN, Q_MAX + 1, size=(MLP_DIMS[i + 1], MLP_DIMS[i])).astype(np.int64)
        b = rng.integers(Q_MIN, Q_MAX + 1, size=MLP_DIMS[i + 1]).astype(np.int64)
        layers.append((w, b))
    return layers, rng.integers(Q_MIN, Q_MAX + 1, size=MLP_DIMS[0]).astype(np.int64)


def cnn_case(name: str):
    """Inputs of one CNN case. (a), (b): ([(kind, fields)], x) in the layer
    form of `convert.model_from_layers`, the draw order of the JAX tests;
    (c): (float ops, calibration inputs) from `lenet_float_ops`."""
    rng = np.random.default_rng(120 + CNN_CASES.index(name))
    if name == "lenet":
        return lenet_float_ops(LENET_TINY, rng)
    if name == "strided":
        kx, n, k, kw, s = 1, 8, 3, 2, 2
        x = rng.integers(Q_MIN, Q_MAX + 1, size=(kx, n, n)).astype(np.int64)
        w = rng.integers(Q_MIN, Q_MAX + 1, size=(kw, kx, k, k)).astype(np.int64)
        b = rng.integers(Q_MIN, Q_MAX + 1, size=kw).astype(np.int64)
        return [("conv", dict(filter=w, bias=b, input_shape=(kx, n, n), stride=s))], x
    kx, n, k, kw = 1, 4, 2, 2
    x = rng.integers(Q_MIN, Q_MAX + 1, size=(kx, n, n)).astype(np.int64)
    w = rng.integers(Q_MIN // 8, Q_MAX // 8, size=(kw, kx, k, k)).astype(np.int64)
    b = rng.integers(Q_MIN, Q_MAX + 1, size=kw).astype(np.int64)
    dmat = rng.integers(Q_MIN, Q_MAX + 1, size=(4, kw * (n // 2) ** 2)).astype(np.int64)
    dbias = rng.integers(Q_MIN, Q_MAX + 1, size=4).astype(np.int64)
    layers = [
        ("conv", dict(filter=w, bias=b, input_shape=(kx, n, n), stride=1)),
        ("requant", dict(multiplier=1.0 / (1 << 10))),  # spec from the conv's bit size
        ("maxpool", dict(input_shape=(kw, n, n))),
        ("flatten", {}),
        ("dense", dict(matrix=dmat, bias=dbias)),
    ]
    return layers, x


def lenet_float_ops(cfg: dict, rng, num_inputs: int = 2):
    """A LeNet float model as [(kind, weight, bias, stride)] and its inputs.

    Weights and biases are drawn in layer order, weight then bias, from
    uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) (PyTorch's default init);
    then `num_inputs` inputs from uniform(-1, 1, input_shape)."""
    ops = []
    c_in = cfg["input_shape"][0]

    def draw(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, size=shape)

    for c_out, k in cfg["convs"]:
        w = draw((c_out, c_in, k, k), c_in * k * k)
        ops += [("conv", w, draw((c_out,), c_in * k * k), 1), ("relu", None, None, 1), ("maxpool", None, None, 1)]
        c_in = c_out
    ops.append(("flatten", None, None, 1))
    cols = cfg["flat_in"]
    for i, rows in enumerate(cfg["denses"]):
        ops.append(("dense", draw((rows, cols), cols), draw((rows,), cols), 1))
        if i < len(cfg["denses"]) - 1:
            ops.append(("relu", None, None, 1))
        cols = rows
    xs = [rng.uniform(-1, 1, size=cfg["input_shape"]) for _ in range(num_inputs)]
    return ops, xs


def layer_records(model) -> list:
    """A quantized Model of either package as [(kind, fields)] numpy records
    (the layer form of `convert.model_from_layers`): conv filter, bias
    (padded to a power of two), input_shape, stride; dense matrix and bias
    (padded); requant the RequantSpec fields; maxpool its input shape (the
    JAX layer has none: it is the conv output's, halved by each pool since);
    relu, flatten none."""
    kinds = {"Convolution": "conv", "Dense": "dense", "Requant": "requant", "Relu": "relu",
             "Maxpool2D": "maxpool", "Flatten": "flatten"}

    def arr(t):
        return np.asarray(t.cpu() if hasattr(t, "cpu") else t, dtype=np.int64)

    out, shape = [], None
    for nid in model.forward_order():
        op = model.nodes[nid].op
        kind = kinds[type(op).__name__]
        if kind == "conv":
            f = dict(filter=arr(op.filter), bias=arr(op.bias), input_shape=tuple(op.input_shape), stride=int(op.stride))
            n = op.input_shape[1] // op.stride
            shape = (f["bias"].shape[0], n, n)
        elif kind == "maxpool":
            f = dict(input_shape=tuple(getattr(op, "input_shape", shape)))
            c, h, w = f["input_shape"]
            shape = (c, h // 2, w // 2)
        elif kind == "dense":
            f = dict(matrix=arr(op.matrix), bias=arr(op.bias))
        elif kind == "requant":
            f = {k: getattr(op.spec, k) for k in REQUANT_FIELDS}
        else:
            f = {}
        out.append((kind, f))
    return out


def numpy_eval(records, x) -> np.ndarray:
    """The output of a quantized chain of `layer_records`, evaluated with
    numpy alone: direct integer cross-correlation (the valid window of the
    padded n x n grid, bias on it, zeros elsewhere), 2 x 2 max, integer
    matmul and the Requant arithmetic."""
    v = np.asarray(x, dtype=np.int64)
    for kind, f in records:
        if kind == "conv":
            w, bias = f["filter"], f["bias"]
            kw_r, kx_r, k, _ = w.shape
            n = f["input_shape"][1]
            m = n - k + 1
            out = np.zeros((bias.shape[0], n, n), dtype=np.int64)
            for dy in range(k):
                for dx in range(k):
                    out[:kw_r, :m, :m] += np.einsum("oc,cyx->oyx", w[:, :, dy, dx], v[:kx_r, dy : dy + m, dx : dx + m])
            out[:, :m, :m] += bias[:, None, None]
            s = f["stride"]
            v = np.ascontiguousarray(out[:, ::s, ::s])
        elif kind == "dense":
            xp = np.zeros(f["matrix"].shape[1], dtype=np.int64)
            xp[: v.size] = v.reshape(-1)
            v = f["matrix"] @ xp + f["bias"]
        elif kind == "requant":
            shift = f["fp_scale"] + f["right_shift"]
            v = np.clip((v * f["fixed_point_multiplier"] + (1 << (shift - 1))) >> shift, Q_MIN, Q_MAX)
        elif kind == "relu":
            v = np.maximum(v, 0)
        elif kind == "maxpool":
            c, h, w_ = v.shape
            v = v.reshape(c, h // 2, 2, w_ // 2, 2).max(axis=(2, 4))
        else:
            v = v.reshape(-1)
    return v


# the residual slice (ROADMAP queue 1 item 2) at the JAX tests' PCS sizes:
# tests/test_fanout.py's residual (a dense output feeding a dense and the
# add), tests/test_zkml_layers.py:25 (an add of two dense branches of the
# input), tests/test_pad.py's Pad2D alone and before a conv, and
# tests/test_capture_and_dag_parser.py:34's residual float DAG quantized
# with the inference observer
RESIDUAL_KW = CNN_KW
RESIDUAL_CASES = ("fanout", "add_branches", "pad", "padded_conv", "residual_float")

# the transformer's first half (queue 1 item 3): tests/test_zkml_layers.py:42
# (a matmul of two witness inputs), tests/test_zkml_transformer.py
# (embeddings -> positional; dense -> requant -> gelu, the requant at 12
# intermediate bits where that test's takes 20: its 2^19-row clamping table
# cost minutes of a CPU prove), tests/test_layernorm.py, and "ffn_fanouts":
# the chip phase's structure at seq 4, width 16, in one graph small enough
# for the JAX package's CPU prove (positional -> layernorm -> requant ->
# matmul with bias -> requant -> gelu -> add of the positional output, then
# a matmul of that sum added back to it: the positional output and the
# first add's each feed two layers, so two merges run in one backward
# walk, beside the gelu, inv_sqrt, range and
# clamping tables; each requant's bits fitted to its input, so its clamping
# table has 2^8 rows).
TRANSFORMER_KW = CNN_KW
TRANSFORMER_CASES = ("matmul_witness", "embeddings", "gelu", "layernorm", "ffn_fanouts")
# The feed-forward halves of two GPT-2 blocks from the positional node on
# (zkml/llm.py:256-261, 380-402) at a tiny config, seq 4: "gpt2_ffn" with
# the builder's Requant bits (the chip phase's graph), "gpt2_ffn_fit" with
# each Requant's bits fitted to its input (clamping tables of 2^6-2^12 rows
# instead of up to 2^17; multipliers, scales and outputs unchanged). Neither
# is frozen: the JAX package's CPU prove of the first ran more than three
# hours without finishing, and of the second spent more than 20 minutes in
# one GKR level of its shared logup (34 instances, 5 variables) before it
# was stopped. So the port's proof of "gpt2_ffn_fit" is held by its
# verifier, and both graphs' layers and inference live against the JAX
# package (tests/test_torch_transformer.py).
GPT2_FIT_CASE = "gpt2_ffn_fit"
# the bits of the eight Requants of "gpt2_ffn", in forward order, fitted as
# |largest input| .bit_length() + 1 (clamping tables 2^8, 2^9, 2^12, 2^6,
# 2^9, 2^9, 2^8, 2^8 rows instead of 2^13, 2^12, 2^17, 2^7, 2^17, 2^12,
# 2^13, 2^10)
GPT2_FIT_BITS = (26, 16, 16, 9, 23, 16, 16, 8)
GPT2_CASE = "gpt2_ffn"
GRAPH_PROOF_PARTS = ("steps", "merges", "table_proofs", "shared_logup", "commit")
# the attention half (queue 1 item 4) at the JAX tests' shapes: a QKV of an
# (4, 8) input with its three Requants (tests/test_qkv.py), a ConcatMatMul
# of two (2, 4, 8)/(2, 8, 4) inputs, its transpose_b form behind two
# Permutes of (4, 2, 8) inputs (tests/test_concat_matmul.py), a Permute
# then a Reshape into a MatMul, the causal Softmax of tests/test_softmax.py
# (an (8, 8) input, max size 64, one zero chunk), Logits of a (4, 16) int8
# input; and "attn_block": the GPT-2 attention half's structure at seq 4,
# width 16, two heads of 8 (positional -> layernorm -> requant -> qkv ->
# three requants -> permutes -> Q K^T -> softmax -> P V -> permute ->
# reshape -> requant -> matmul -> requant -> the add of the positional
# output, its fan-out merged; then requant -> matmul -> requant -> logits),
# each Requant's multiplier set to about 100 / its largest input and its
# bits fitted to it (clamping tables of 2^8 and 2^9 rows); and
# "attn_fanout", the same attention half cut so that the JAX package's CPU
# prove finishes: no LayerNorm and no Logits tail, four Requants with
# multipliers above 2^-8 (a 32-bit shift: four range chunks each) and 19
# bits, so that they share one 2^12-row clamping table (positional -> qkv
# -> three requants -> permutes -> Q K^T -> softmax -> P V -> permute ->
# reshape -> requant -> matmul -> the add of the positional output, its
# fan-out merged), 20 instances in its largest consolidated logup.
ATTENTION_KW = CNN_KW
ATTENTION_CASES = ("qkv", "concat_matmul", "concat_matmul_t", "permute", "softmax", "logits", "attn_block",
                   "attn_fanout")
# the cases whose JAX proofs are frozen: attn_block's JAX CPU prove (its
# consolidated logup of 47 instances) ran more than three and a half
# hours without finishing, so it is held live (its layers against the JAX
# package, its proof by the port's verifier) and through attn_fanout
ATTENTION_FROZEN = tuple(c for c in ATTENTION_CASES if c != "attn_block")
# attn_block's Requants (multiplier, bits) in node order, and its Softmax
ATTN_REQUANTS = {2: (5.68e-06, 26), 4: (0.004, 16), 5: (0.00333, 16), 6: (0.00466, 16), 15: (0.00026, 20),
                 17: (0.00346, 16), 19: (0.524, 9), 21: (0.00315, 16)}
ATTN_SOFTMAX = dict(s_in=0.0005762028158642352, max_size=64, temperature=0.35355339059327373, seq=4,
                    domain_max=27768)
GPT2_TINY = dict(vocab=32, emb=16, heads=2, blocks=2, context=8)
GPT2_TINY_SEQ = 4
GPT2_TINY_TOKENS = (3, 7, 1, 5)
# GPT-2-124M (bench.py:292-296) and the chip phase gpt2_ffn's cut of it:
# the vocabulary, context, depth (the calibration runs all 12 blocks), head
# width 64, seq 64 and prompt kept, the width cut from 768 to 128 (2 heads).
# At 768 the JAX package's quantization gives clamping tables of 2^26 rows
# (block 0's down-projection Requant) and 2^28 (block 1's LayerNorm
# Requant), and the batch opening tiles every claim to the largest
# polynomial; at 128 the largest is a clamping table of 2^22 rows.
GPT2_124M = dict(vocab=50257, emb=768, heads=12, blocks=12, context=1024)
GPT2_FFN_CHIP = dict(GPT2_124M, emb=128, heads=2)
GPT2_124M_SEQ = 64
# The chip phase gpt2: GPT-2-124M's whole graph (Embeddings to Logits) at its
# vocabulary, width, heads, context, seq and prompt, cut to two of its 12
# blocks: from block 2 on a LayerNorm's Requant needs a 2^29-row clamping
# table, and from block 6 most need 2^30, which the card cannot commit
# and prove (scripts/gpt2_requant_widths.py); two blocks' largest table is
# 2^28 rows, one block's too.
GPT2_CHIP = dict(GPT2_124M, blocks=2)


def _ints(rng, shape, lo=Q_MIN, hi=Q_MAX + 1):
    return rng.integers(lo, hi, size=shape).astype(np.int64)


def graph_case(name: str) -> dict:
    """One residual or transformer case. A layer graph is
    {"nodes": [(kind, fields, [(producer index or None, wire)])],
    "inputs": [int64 arrays]}: the producer index is a position in `nodes`,
    None a model input (the wire then its index). Kinds and fields: dense
    (matrix, bias), add, pad (pad, input_shape), conv (filter, bias,
    input_shape, stride), matmul (two witness inputs), embeddings (table),
    positional (table), requant (multiplier, bits: RequantSpec.from_multiplier),
    gelu (s_in, s_out), layernorm (gamma_f, beta_f, eps, s_in:
    LayerNorm.from_float). "residual_float" is {"float": [(kind, weight,
    bias, [input ids])], "input_shape", "cal": calibration inputs}, quantized
    with the inference observer, cal[0] proved; "gpt2_ffn" is {"gpt2":
    config, "seq", "tokens"}, built by each package's `GPT2Builder`, and
    "gpt2_ffn_fit" the same with "requant_bits" (`gpt2_ffn_graph`)."""
    if name in ("gpt2_ffn", "gpt2_ffn_fit"):
        case = {"gpt2": dict(GPT2_TINY), "seq": GPT2_TINY_SEQ, "tokens": np.array(GPT2_TINY_TOKENS, dtype=np.int64)}
        return {**case, "requant_bits": GPT2_FIT_BITS} if name == "gpt2_ffn_fit" else case
    if name in ATTENTION_CASES:
        return attention_case(name)
    seeds = {n: 130 + i for i, n in enumerate(RESIDUAL_CASES + TRANSFORMER_CASES)}
    rng = np.random.default_rng(seeds[name])
    if name == "fanout":
        d0, b0, d1, b1 = _ints(rng, (8, 8)), _ints(rng, 8), _ints(rng, (8, 8)), _ints(rng, 8)
        nodes = [("dense", dict(matrix=d0, bias=b0), [(None, 0)]),
                 ("dense", dict(matrix=d1, bias=b1), [(0, 0)]),
                 ("add", {}, [(0, 0), (1, 0)])]
        return {"nodes": nodes, "inputs": [_ints(rng, 8)]}
    if name == "add_branches":
        d0, b0, d1, b1 = _ints(rng, (8, 8)), _ints(rng, 8), _ints(rng, (8, 8)), _ints(rng, 8)
        nodes = [("dense", dict(matrix=d0, bias=b0), [(None, 0)]),
                 ("dense", dict(matrix=d1, bias=b1), [(None, 0)]),
                 ("add", {}, [(0, 0), (1, 0)])]
        return {"nodes": nodes, "inputs": [_ints(rng, 8)]}
    if name == "pad":
        return {"nodes": [("pad", dict(pad=1, input_shape=(2, 4, 4)), [(None, 0)])],
                "inputs": [_ints(rng, (2, 4, 4))]}
    if name == "padded_conv":
        x, w, b = _ints(rng, (1, 4, 4)), _ints(rng, (2, 1, 3, 3)), _ints(rng, 2)
        nodes = [("pad", dict(pad=1, input_shape=(1, 4, 4)), [(None, 0)]),
                 ("conv", dict(filter=w, bias=b, input_shape=(1, 8, 8), stride=1), [(0, 0)])]
        return {"nodes": nodes, "inputs": [x]}
    if name == "residual_float":
        dim = 8
        w0, b0 = rng.normal(0, 0.3, (dim, dim)), rng.normal(0, 0.1, dim)
        w1, b1 = rng.normal(0, 0.3, (dim, dim)), rng.normal(0, 0.1, dim)
        ops = [("dense", w0, b0, [-1]), ("relu", None, None, [0]), ("dense", w1, b1, [1]),
               ("add", None, None, [0, 2])]
        return {"float": ops, "input_shape": (dim,), "cal": [rng.uniform(-1, 1, dim) for _ in range(4)]}
    if name == "matmul_witness":
        return {"nodes": [("matmul", {}, [(None, 0), (None, 1)])],
                "inputs": [_ints(rng, (4, 8)), _ints(rng, (8, 4))]}
    if name == "embeddings":
        emb, pos = _ints(rng, (16, 8)), _ints(rng, (4, 8))
        nodes = [("embeddings", dict(table=emb), [(None, 0)]), ("positional", dict(table=pos), [(0, 0)])]
        return {"nodes": nodes, "inputs": [rng.integers(0, 16, size=4).astype(np.int64)]}
    if name == "gelu":
        nodes = [("dense", dict(matrix=np.eye(8, dtype=np.int64), bias=np.zeros(8, dtype=np.int64)), [(None, 0)]),
                 ("requant", dict(multiplier=0.5, bits=12), [(0, 0)]),
                 ("gelu", dict(s_in=1.0 / 64, s_out=1.0 / 64), [(1, 0)])]
        return {"nodes": nodes, "inputs": [_ints(rng, 8)]}
    if name == "layernorm":
        gamma_f, beta_f = rng.normal(1.0, 0.2, size=16), rng.normal(0.0, 0.1, size=16)
        ln = dict(gamma_f=gamma_f, beta_f=beta_f, eps=1e-5, s_in=1.0 / 64.0)
        return {"nodes": [("layernorm", ln, [(None, 0)])], "inputs": [_ints(rng, (4, 16))]}
    if name == "ffn_fanouts":
        x, pos = _ints(rng, (4, 16), -64, 64), _ints(rng, (4, 16), -64, 64)
        ln = dict(gamma_f=rng.normal(1.0, 0.2, size=16), beta_f=rng.normal(0.0, 0.1, size=16), eps=1e-5,
                  s_in=1.0 / 64.0)
        w1, b1, w2, b2 = _ints(rng, (16, 16)), _ints(rng, 16, -1000, 1000), _ints(rng, (16, 16)), _ints(rng, 16, -1000, 1000)
        nodes = [("positional", dict(table=pos), [(None, 0)]),
                 ("layernorm", ln, [(0, 0)]),
                 ("requant", dict(multiplier=6.18e-06, bits=25), [(1, 0)]),
                 ("matmul", dict(right=w1, bias=b1), [(2, 0)]),
                 ("requant", dict(multiplier=0.00353, bits=16), [(3, 0)]),
                 ("gelu", dict(s_in=1.0 / 16, s_out=1.0 / 16), [(4, 0)]),
                 ("add", {}, [(0, 0), (5, 0)]),
                 ("matmul", dict(right=w2, bias=b2), [(6, 0)]),
                 ("add", {}, [(6, 0), (7, 0)])]
        return {"nodes": nodes, "inputs": [x]}
    raise ValueError(name)


def attention_case(name: str) -> dict:
    """One case of the attention part, in `graph_case`'s layer-graph form."""
    rng = np.random.default_rng(150 + ATTENTION_CASES.index(name))
    permute = lambda shape: ("permute", dict(perm=(1, 0, 2), in_shape=shape))  # noqa: E731
    if name == "qkv":
        ws, bs = [_ints(rng, (8, 8)) for _ in range(3)], [_ints(rng, 8) for _ in range(3)]
        rq = dict(multiplier=1.0 / 128 / 8, bits=2 * 7 + 3 + 1)  # QKV.output_bitsize at k = 8
        nodes = [("qkv", dict(ws=ws, bs=bs), [(None, 0)])] + [("requant", rq, [(0, w)]) for w in range(3)]
        return {"nodes": nodes, "inputs": [_ints(rng, (4, 8))]}
    if name == "concat_matmul":
        return {"nodes": [("concat_matmul", dict(transpose_b=False), [(None, 0), (None, 1)])],
                "inputs": [_ints(rng, (2, 4, 8)), _ints(rng, (2, 8, 4))]}
    if name == "concat_matmul_t":
        nodes = [(*permute((4, 2, 8)), [(None, 0)]), (*permute((4, 2, 8)), [(None, 1)]),
                 ("concat_matmul", dict(transpose_b=True), [(0, 0), (1, 0)])]
        return {"nodes": nodes, "inputs": [_ints(rng, (4, 2, 8)), _ints(rng, (4, 2, 8))]}
    if name == "permute":
        nodes = [(*permute((4, 2, 8)), [(None, 0)]), ("reshape", dict(shape=(8, 8)), [(0, 0)]),
                 ("matmul", dict(right=_ints(rng, (8, 8)), bias=_ints(rng, 8)), [(1, 0)])]
        return {"nodes": nodes, "inputs": [_ints(rng, (4, 2, 8))]}
    if name == "softmax":
        sm = dict(s_in=1.0 / 32.0, max_size=64, temperature=1.0, seq=8, domain_max=Q_MAX)
        return {"nodes": [("softmax", sm, [(None, 0)])], "inputs": [_ints(rng, (8, 8))]}
    if name == "logits":
        return {"nodes": [("logits", {}, [(None, 0)])], "inputs": [_ints(rng, (4, 16))]}
    if name == "attn_fanout":
        x, pos = _ints(rng, (4, 16), -16, 16), _ints(rng, (4, 16), -16, 16)
        ws, bs = [_ints(rng, (16, 16)) for _ in range(3)], [_ints(rng, 16, -100, 100) for _ in range(3)]
        w1, b1 = _ints(rng, (16, 16)), _ints(rng, 16, -1000, 1000)
        rq = lambda m: dict(multiplier=m, bits=19)  # noqa: E731
        sm = dict(s_in=16 / 2538, max_size=64, temperature=8 ** -0.5, seq=4, domain_max=2538)  # |Q K^T| <= 2538
        nodes = [("positional", dict(table=pos), [(None, 0)]),
                 ("qkv", dict(ws=ws, bs=bs), [(0, 0)]),
                 ("requant", rq(0.005), [(1, 0)]), ("requant", rq(0.005), [(1, 1)]),
                 ("requant", rq(0.005), [(1, 2)]),
                 (*permute((4, 2, 8)), [(2, 0)]), (*permute((4, 2, 8)), [(3, 0)]), (*permute((4, 2, 8)), [(4, 0)]),
                 ("concat_matmul", dict(transpose_b=True), [(5, 0), (6, 0)]),
                 ("softmax", sm, [(8, 0)]),
                 ("concat_matmul", dict(transpose_b=False), [(9, 0), (7, 0)]),
                 (*permute((2, 4, 8)), [(10, 0)]),
                 ("reshape", dict(shape=(4, 16)), [(11, 0)]),
                 ("requant", rq(0.004), [(12, 0)]),
                 ("matmul", dict(right=w1, bias=b1), [(13, 0)]),
                 ("add", {}, [(0, 0), (14, 0)])]
        return {"nodes": nodes, "inputs": [x]}
    x, pos = _ints(rng, (4, 16), -64, 64), _ints(rng, (4, 16), -64, 64)
    ln = dict(gamma_f=rng.normal(1.0, 0.2, size=16), beta_f=rng.normal(0.0, 0.1, size=16), eps=1e-5, s_in=1.0 / 64)
    ws, bs = [_ints(rng, (16, 16)) for _ in range(3)], [_ints(rng, 16, -1000, 1000) for _ in range(3)]
    w1, b1, w2 = _ints(rng, (16, 16)), _ints(rng, 16, -1000, 1000), _ints(rng, (16, 16))
    nodes = [("positional", dict(table=pos), [(None, 0)]),
             ("layernorm", ln, [(0, 0)]),
             ("requant", None, [(1, 0)]),
             ("qkv", dict(ws=ws, bs=bs), [(2, 0)]),
             ("requant", None, [(3, 0)]), ("requant", None, [(3, 1)]), ("requant", None, [(3, 2)]),
             (*permute((4, 2, 8)), [(4, 0)]), (*permute((4, 2, 8)), [(5, 0)]), (*permute((4, 2, 8)), [(6, 0)]),
             ("concat_matmul", dict(transpose_b=True), [(7, 0), (8, 0)]),
             ("softmax", dict(ATTN_SOFTMAX), [(10, 0)]),
             ("concat_matmul", dict(transpose_b=False), [(11, 0), (9, 0)]),
             (*permute((2, 4, 8)), [(12, 0)]),
             ("reshape", dict(shape=(4, 16)), [(13, 0)]),
             ("requant", None, [(14, 0)]),
             ("matmul", dict(right=w1, bias=b1), [(15, 0)]),
             ("requant", None, [(16, 0)]),
             ("add", {}, [(0, 0), (17, 0)]),
             ("requant", None, [(18, 0)]),
             ("matmul", dict(right=w2, bias=np.zeros(16, dtype=np.int64)), [(19, 0)]),
             ("requant", None, [(20, 0)]),
             ("logits", {}, [(21, 0)])]
    for i, (mult, bits) in ATTN_REQUANTS.items():
        nodes[i] = ("requant", dict(multiplier=mult, bits=bits), nodes[i][2])
    return {"nodes": nodes, "inputs": [x]}


def gpt2_ffn_graph(llm, model_mod, positional_cls, cfg: dict, seq: int, tokens, table=lambda a: a,
                   requant_bits=None, **builder_kw):
    """The chip path's graph, built with one package's modules (`llm`,
    `model` and the Positional class): GPT-2 from its Positional node
    (llm.py:256-261) through the feed-forward halves of blocks 0 and 1
    (`GPT2Builder._ffn`, llm.py:380-402), synthetic weights from seed 0,
    scales from `_calibrate(tokens)`; `table` turns the positional numpy
    table into the package's table type. `requant_bits`, where given, gives
    the Requants in forward order these intermediate bit sizes, their
    multipliers kept. Returns (builder, model, the model
    input: the Embeddings node's output, its table padded to powers of two,
    at the tokens padded to `seq`)."""
    w = llm.GPT2Weights.synthetic(llm.LLMConfig(**cfg), seed=0)
    b = llm.GPT2Builder(w, seq, **builder_kw)
    sc = b._calibrate(np.asarray(tokens, dtype=np.int64))
    s_emb = max(llm._mx(w.wte), llm._mx(w.wpe)) / Q_MAX
    m = model_mod.Model(num_inputs=1)
    pos_id = m.add_node(positional_cls(table=table(llm._q(w.wpe[: b.seq], s_emb))),
                        [model_mod.Edge(node=None, index=0)])
    x1, s1 = b._ffn(m, pos_id, s_emb, w.blocks[0], 0, sc)
    b._ffn(m, x1, s1, w.blocks[1], 1, sc)
    if requant_bits is not None:
        requants = [n for n in m.forward_order() if isinstance(m.nodes[n].op, llm.Requant)]
        assert len(requants) == len(requant_bits)
        for nid, bits in zip(requants, requant_bits):
            spec = llm.RequantSpec.from_multiplier(m.nodes[nid].op.spec.multiplier, bits)
            m.nodes[nid].op = llm.Requant(spec=spec)
    toks = np.zeros(b.seq, dtype=np.int64)
    toks[: len(tokens)] = np.asarray(tokens)[: b.seq]
    emb = llm._q(w.wte, s_emb)
    d = 1 << max(0, (emb.shape[1] - 1).bit_length())
    x = np.zeros((b.seq, d), dtype=np.int64)
    x[:, : emb.shape[1]] = emb[toks]
    return b, m, x


def port_graph(case: dict, device):
    """The port's Model of one `graph_case` on `device` and its inputs as
    int64 numpy arrays (imports the port, never JAX)."""
    import torch

    from deepprove_tpu_torch.zkml import llm
    from deepprove_tpu_torch.zkml import model as model_mod
    from deepprove_tpu_torch.zkml.convert import float_model_from_graph, model_from_graph
    from deepprove_tpu_torch.zkml.float_model import quantize
    from deepprove_tpu_torch.zkml.layers.embeddings import Positional

    if "gpt2" in case:
        _, model, x = gpt2_ffn_graph(llm, model_mod, Positional, case["gpt2"], case["seq"], case["tokens"],
                                     table=lambda a: torch.from_numpy(a).to(device),
                                     requant_bits=case.get("requant_bits"), device=device)
        return model, [x]
    if "float" in case:
        fm = float_model_from_graph(case["input_shape"], case["float"])
        model, s_in, _ = quantize(fm, "inference", case["cal"], device=device)
        return model, [s_in.quantize(case["cal"][0])]
    return model_from_graph(case["nodes"], len(case["inputs"]), device=device), list(case["inputs"])


def graph_records(model) -> list:
    """A quantized DAG of either package as [(kind, fields, edges)] numpy
    records, edges [(producer node or None, wire)]: embeddings and
    positional table; layernorm gamma, beta (padded), dim_size, multiplier,
    eps, range_check_bits; requant the RequantSpec fields; matmul
    right_const, bias (None where absent); gelu s_in, s_out; qkv ws, bs;
    permute perm, in_shape; concat_matmul transpose_b; softmax the fields
    its output is made from (s_in, inv_temp, scalar, seq, bkm, sts, ztv,
    n_zero_chunks, neg_inf); reshape shape; add and logits none."""
    kinds = {"Positional": "positional", "LayerNorm": "layernorm", "Requant": "requant", "MatMul": "matmul",
             "Gelu": "gelu", "Add": "add", "Embeddings": "embeddings", "QKV": "qkv", "Permute": "permute",
             "ConcatMatMul": "concat_matmul", "Softmax": "softmax", "Reshape": "reshape", "Logits": "logits"}

    def arr(t):
        return None if t is None else np.asarray(t.cpu() if hasattr(t, "cpu") else t, dtype=np.int64)

    out = []
    for nid in model.forward_order():
        op = model.nodes[nid].op
        kind = kinds[type(op).__name__]
        if kind in ("positional", "embeddings"):
            f = dict(table=arr(op.table))
        elif kind == "qkv":
            f = dict(ws=[arr(w) for w in op.ws], bs=[arr(b) for b in op.bs])
        elif kind == "permute":
            f = dict(perm=tuple(op.perm), in_shape=tuple(op.in_shape))
        elif kind == "concat_matmul":
            f = dict(transpose_b=op.transpose_b)
        elif kind == "softmax":
            f = {k: getattr(op, k) for k in ("s_in", "inv_temp", "scalar", "seq", "bkm", "sts", "ztv",
                                             "n_zero_chunks", "neg_inf")}
        elif kind == "reshape":
            f = dict(shape=tuple(op.shape))
        elif kind == "layernorm":
            f = dict(gamma=arr(op.gamma), beta=arr(op.beta), dim_size=op.dim_size, multiplier=op.multiplier,
                     eps=op.eps, range_check_bits=op.range_check_bits)
        elif kind == "requant":
            f = {k: getattr(op.spec, k) for k in REQUANT_FIELDS}
        elif kind == "matmul":
            assert op.left_const is None, "a constant left operand is not on the GPT-2 path"
            f = dict(right_const=arr(op.right_const), bias=arr(op.bias))
        elif kind == "gelu":
            f = dict(s_in=op.s_in, s_out=op.s_out)
        else:
            f = {}
        out.append((kind, f, [(e.node, e.index) for e in model.nodes[nid].inputs]))
    return out


def _f32(v: float) -> float:
    return float(np.float32(v))


def _imatmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """An integer matrix product through float64 BLAS: exact while every
    partial sum stays below 2^53, which the bound checks."""
    bound = float(np.abs(a).max(initial=0)) * float(np.abs(b).max(initial=0)) * a.shape[-1]
    assert bound < 2.0**52, "the float64 product would round"
    return np.rint(a.astype(np.float64) @ b.astype(np.float64)).astype(np.int64)


def _softmax_np(x: np.ndarray, f: dict) -> np.ndarray:
    """The quantized softmax of `graph_records`' fields, in numpy: each
    row's negated log-sum-exp at 2^24 in float32, the causal mask, the
    decomposition of |value| into 8 + 8 bits, the exp table's index and the
    zero chunks, the exp table's row (float32, 0 from bkm on) times the
    chunks' zero flags."""
    x2 = x.reshape(-1, x.shape[-1]).astype(np.int64)
    r, c = x2.shape
    seq = f["seq"]
    tril = np.ones((r, c), dtype=np.int64) if seq is None else (
        np.arange(c)[None, :] <= (np.arange(r) % seq)[:, None]).astype(np.int64)
    shift = np.zeros(r, dtype=np.int64)
    for i in range(r):
        active = x2[i][tril[i].astype(bool)]
        mx = np.int64(active.max())
        sm = np.sum(np.exp((active - mx).astype(np.float32) * np.float32(f["s_in"] / f["inv_temp"])),
                    dtype=np.float32)
        shift[i] = -np.int64(round(float((1 << 24) * f["inv_temp"] * np.log(sm, dtype=np.float32)))) - mx * np.int64(
            f["scalar"])
    masked = (x2 * f["scalar"] + shift[:, None]) * tril + f["neg_inf"] * (1 - tril)
    a = -masked
    j = np.arange(1 << f["sts"], dtype=np.int64)
    prod = np.int64(1 << 16) * j
    e = np.exp(-(prod.astype(np.float32)) / (np.float32(1 << 24) * np.float32(f["inv_temp"])))
    table = np.where(prod >= f["bkm"], 0, np.round(e * np.float32(1 << 12)).astype(np.int64))
    out = table[(a >> 16) & ((1 << f["sts"]) - 1)]
    a = a >> (16 + f["sts"])
    for _ in range(f["n_zero_chunks"]):
        out = out * ((a & ((1 << f["ztv"]) - 1)) == 0)
        a = a >> f["ztv"]
    assert (a == 0).all()
    return out.reshape(x.shape)


def numpy_eval_graph(records, inputs) -> np.ndarray:
    """The last node's output of a `graph_records` DAG, evaluated with numpy
    int64 alone: E[tokens]; x + P; LayerNorm's integer rows through the
    InverseSQRT table (rows from -2^14, out = round(2^10 / sqrt(v 2^rc /
    2^24 + eps))); the Requant arithmetic; an integer matmul with bias,
    padded to powers of two; GELU through its table (inputs MIN - 1 ..=
    MAX, tanh form, the scales as float32); an integer add; the three QKV
    projections; a transpose; the per-head products; the quantized softmax
    (`_softmax_np`); a reshape; the argmax of each row."""

    def pow2(n):
        return 1 << max(0, (int(n) - 1).bit_length())

    vals = {}
    for nid, (kind, f, edges) in enumerate(records):
        xs = [np.asarray(inputs[w]) if n is None else vals[n][w] for n, w in edges]
        x = xs[0]
        if kind == "embeddings":
            v = f["table"][x.reshape(-1)]
        elif kind == "qkv":
            xp = np.zeros((pow2(x.shape[0]), f["ws"][0].shape[0]), dtype=np.int64)
            xp[: x.shape[0], : x.shape[1]] = x
            vals[nid] = [_imatmul(xp, w) + b[None, :] for w, b in zip(f["ws"], f["bs"])]
            continue
        elif kind == "permute":
            v = np.ascontiguousarray(np.transpose(x.reshape(f["in_shape"]), f["perm"]))
        elif kind == "concat_matmul":
            b = np.transpose(xs[1], (0, 2, 1)) if f["transpose_b"] else xs[1]
            v = np.stack([_imatmul(x[h], b[h]) for h in range(x.shape[0])])
        elif kind == "softmax":
            v = _softmax_np(x, f)
        elif kind == "reshape":
            v = x.reshape(f["shape"])
        elif kind == "logits":
            v = np.argmax(x, axis=-1)
        elif kind == "positional":
            t = f["table"]
            v = x + t[: x.shape[0]]
        elif kind == "layernorm":
            g, b = f["gamma"], f["beta"]
            xp = np.zeros((pow2(x.shape[0]), g.size), dtype=np.int64)
            xp[: x.shape[0], : x.shape[1]] = x
            s = xp.sum(axis=1)
            full = f["multiplier"] * (f["dim_size"] * (xp * xp).sum(axis=1) - s * s)
            mx = 1 << 14
            rows = np.arange(-mx, mx, dtype=np.float64) * float(1 << f["range_check_bits"]) / float(1 << 24)
            with np.errstate(invalid="ignore", divide="ignore"):
                inv = 1.0 / np.sqrt(rows + _f32(f["eps"]))
            table = np.where(np.isfinite(inv), np.round(inv * (1 << 10)), 0.0).astype(np.int64)
            v = g[None, :] * (f["dim_size"] * xp - s[:, None]) * table[(full >> f["range_check_bits"]) + mx][:, None]
            v = v + b[None, :]
        elif kind == "requant":
            shift = f["fp_scale"] + f["right_shift"]
            v = np.clip((x * f["fixed_point_multiplier"] + (1 << (shift - 1))) >> shift, Q_MIN, Q_MAX)
        elif kind == "matmul":
            w = f["right_const"]
            a = np.zeros((x.shape[0], w.shape[0]), dtype=np.int64)
            a[:, : x.shape[1]] = x
            c = _imatmul(a, w)
            if f["bias"] is not None:
                c = c + f["bias"][None, : c.shape[1]]
            v = np.zeros((pow2(c.shape[0]), pow2(c.shape[1])), dtype=np.int64)
            v[: c.shape[0], : c.shape[1]] = c
        elif kind == "gelu":
            i = np.arange(Q_MIN - 1, Q_MAX + 1, dtype=np.int64)
            z = i.astype(np.float64) * _f32(f["s_in"])
            gz = 0.5 * z * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (z + 0.044715 * z**3)))
            table = np.clip(np.round(gz / _f32(f["s_out"])), Q_MIN, Q_MAX).astype(np.int64)
            v = table[x - (Q_MIN - 1)]
        else:
            v = xs[0] + xs[1]
        vals[nid] = [v]
    return vals[len(records) - 1][0]


def _ext(rng):
    return tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))


def _table_with_lookups(rng, bits, n_lookups):
    table = np.arange(1 << bits, dtype=np.uint64)
    lookups = rng.integers(0, 1 << bits, size=n_lookups, dtype=np.uint64)
    mult = np.bincount(lookups.astype(np.int64), minlength=1 << bits).astype(np.uint64)
    return table, lookups, mult


def logup_case(name: str) -> list:
    """The proofs of one case, each a dict: `kind` ("lookup", "table",
    "grouped_lookups" or "grouped_tables"), the transcript `label`, and its
    inputs as numpy uint64 columns and host ext-pair challenges:
      lookup: columns, cpi (columns per instance), const, sep;
      table: columns, mult, const, sep;
      grouped_lookups: instances [(columns, const, sep)];
      grouped_tables: instances [(columns, mult, const, sep)]."""
    rng = np.random.default_rng(110 + LOGUP_CASES.index(name))
    if name in ("single", "multi"):
        num_cols, cpi, n = (1, 1, 4) if name == "single" else (4, 2, 3)
        cols = [rng.integers(0, 1 << 8, size=1 << n, dtype=np.uint64) for _ in range(num_cols)]
        return [dict(kind="lookup", label=b"lk", columns=cols, cpi=cpi, const=_ext(rng), sep=_ext(rng))]
    if name in ("table", "wrong_multiplicity"):
        bits = 4 if name == "table" else 3
        table, lookups, mult = _table_with_lookups(rng, bits, 1 << (bits + 1))
        if name == "wrong_multiplicity":
            mult[0] += 1
        const, sep = _ext(rng), _ext(rng)
        return [
            dict(kind="lookup", label=b"a", columns=[lookups], cpi=1, const=const, sep=sep),
            dict(kind="table", label=b"b", columns=[table], mult=mult, const=const, sep=sep),
        ]
    if name == "grouped_lookups":
        const = _ext(rng)
        instances = []
        for k in (2, 1, 1, 2):
            cols = [rng.integers(0, 1 << 8, size=1 << 3, dtype=np.uint64) for _ in range(k)]
            instances.append((cols, const, _ext(rng)))
        return [dict(kind="grouped_lookups", label=b"gl", instances=instances)]
    # two equal-size tables: an (in, out) pair and a one-column range
    bits = 4
    a_in, a_lookups, mult_a = _table_with_lookups(rng, bits, 1 << 5)
    b_col, _, mult_b = _table_with_lookups(rng, bits, 1 << 5)
    const = _ext(rng)
    instances = [([a_in, (a_in * 3 + 1) % P], mult_a, const, _ext(rng)),
                 ([b_col], mult_b, const, _ext(rng))]
    return [dict(kind="grouped_tables", label=b"g", instances=instances)]


def plain(obj):
    """A materialized proof (either package) as JSON-able lists, dicts and ints."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return plain(obj.tolist())
    if isinstance(obj, (np.integer, int)):
        return int(obj)
    if obj is None or isinstance(obj, (bool, str)):
        return obj
    raise TypeError(f"cannot normalise {type(obj)}")


def load():
    with open(REFERENCE_PATH) as f:
        return json.load(f)


def goldilocks_probe_plain(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """What the CUDA library's `goldilocks_probe` must give, in Python ints:
    for u64 operands (any in [0, 2^64), not only canonical ones) the (4, N)
    rows a*b, a*b + c, a + c, 7(a + b + c), each mod p."""
    rows = [[], [], [], []]
    for x, y, z in zip(map(int, a), map(int, b), map(int, c)):
        rows[0].append(x * y % P)
        rows[1].append((x * y + z) % P)
        rows[2].append((x + z) % P)
        rows[3].append(7 * (x + y + z) % P)
    return np.array(rows, dtype=np.uint64)
