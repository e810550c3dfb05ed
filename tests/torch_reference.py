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
