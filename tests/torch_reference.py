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

# basefold: one 2^6 poly (RS path) and one 2^2 poly (trivial commitment)
BASEFOLD_KW = dict(num_queries=11, basecode_msg_size_log=2)
BASEFOLD_MAX_LOG = 6
BASEFOLD_LABEL = b"torch-port basefold"

# the Dense chain of the slice test
DENSE_DIMS = [16, 32, 8]
DENSE_KW = dict(num_queries=11, basecode_msg_size_log=2)


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
