"""The port's Goldilocks field (deepprove_tpu_torch.fields.gf) against the
JAX package's numpy host field (deepprove_tpu.fields.host) on the same
seeded random vectors. Field arithmetic: results must be exact."""

import numpy as np
import pytest
import torch

from deepprove_tpu.fields import host as ref
from deepprove_tpu_torch.fields import gf

P = ref.P
EDGE = np.array(
    [0, 1, 2, P - 1, P - 2, (1 << 32) - 1, 1 << 32, (1 << 32) + 1, P >> 1, 1 << 63,
     (1 << 63) - 1, P - (1 << 32)],
    dtype=np.uint64,
)


def operands(seed, n=4096):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, P, size=n, dtype=np.uint64)
    b = rng.integers(0, P, size=n, dtype=np.uint64)
    ea, eb = np.meshgrid(EDGE, EDGE)
    return np.concatenate([a, ea.ravel()]), np.concatenate([b, eb.ravel()])


@pytest.mark.parametrize(
    "port, want",
    [(gf.add, ref.add), (gf.sub, ref.sub), (gf.mul, ref.mul)],
    ids=["add", "sub", "mul"],
)
def test_binary_op_matches_host(port, want):
    a, b = operands(1)
    got = gf.to_u64(port(gf.from_u64(a), gf.from_u64(b)))
    np.testing.assert_array_equal(got, want(a, b))


def test_mul_by_python_int_matches_host():
    a, _ = operands(2)
    for c in [0, 1, 7, (1 << 32) - 1, 1 << 32, P - 1]:
        got = gf.to_u64(gf.mul(gf.from_u64(a), c))
        np.testing.assert_array_equal(got, ref.mul(a, np.full_like(a, c)))
        got = gf.to_u64(gf.add(gf.from_u64(a), c))
        np.testing.assert_array_equal(got, ref.add(a, np.full_like(a, c)))


def test_neg_matches_host():
    a, _ = operands(3)
    np.testing.assert_array_equal(gf.to_u64(gf.neg(gf.from_u64(a))), ref.neg(a))


def test_inv_matches_host():
    a, _ = operands(4, n=64)
    np.testing.assert_array_equal(gf.to_u64(gf.inv(gf.from_u64(a))), ref.inv(a))


def test_sum_axis_matches_python_sum():
    a, _ = operands(5)
    t = gf.from_u64(a.reshape(-1, 4))
    want = [sum(int(v) for v in col) % P for col in a.reshape(-1, 4).T]
    assert gf.to_u64(gf.sum_axis(t, 0)).tolist() == want
    assert int(gf.to_u64(gf.sum_axis(gf.from_u64(a), 0))) == sum(int(v) for v in a) % P


def _ext(seed, n=1024):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, P, size=(n, 2), dtype=np.uint64)
    return v, gf.GF2(gf.from_u64(v[:, 0]), gf.from_u64(v[:, 1]))


def test_ext_mul_matches_host():
    (a, ta), (b, tb) = _ext(6), _ext(7)
    got = gf.ext_mul(ta, tb)
    want = ref.ext_mul_v(a, b)
    np.testing.assert_array_equal(gf.to_u64(got.a0), want[:, 0])
    np.testing.assert_array_equal(gf.to_u64(got.a1), want[:, 1])


def test_ext_inv_matches_host():
    a, ta = _ext(8, n=32)
    got = gf.ext_inv(ta)
    for i in range(32):
        want = ref.ext_inv((int(a[i, 0]), int(a[i, 1])))
        assert (int(gf.to_u64(got.a0[i])), int(gf.to_u64(got.a1[i]))) == want


def test_canonical_inputs_only_hold_uint64_bit_patterns():
    t = gf.from_u64(np.array([P - 1, P, P + 5], dtype=np.uint64))
    assert t.dtype == torch.int64
    assert gf.to_u64(t).tolist() == [P - 1, 0, 5]


def _lazy_operands(seed):
    """Canonical operands plus u64 values in [p, 2^64): what a lazy product may hold."""
    a, b = operands(seed, n=1024)
    over = np.array([P, P + 1, (1 << 64) - 1, (1 << 64) - (1 << 31), P + (1 << 31)], dtype=np.uint64)
    return np.concatenate([a, over, over]), np.concatenate([b, over, over[::-1]])


def _as_tensor(u64):
    return torch.from_numpy(np.ascontiguousarray(u64).view(np.int64))


def _mod_products(a, b):
    return np.array([int(x) * int(y) % P for x, y in zip(a, b)], dtype=np.uint64)


@pytest.mark.parametrize("which", ["mul_lazy", "square_lazy"])
def test_lazy_products_take_any_u64_and_stay_below_2_64(which):
    a, b = _lazy_operands(6)
    if which == "square_lazy":
        b = a
        got = gf.square_lazy(_as_tensor(a))
    else:
        got = gf.mul_lazy(_as_tensor(a), _as_tensor(b))
    want = _mod_products(a, b)
    np.testing.assert_array_equal(gf.to_u64(gf._canon_once(got)), want)
    np.testing.assert_array_equal(gf.to_u64(gf.square(gf.from_u64(a[:1024]))), _mod_products(a[:1024], a[:1024]))


@pytest.mark.parametrize("c", [0, 1, 7, (1 << 31) - 1])
def test_mul_small_matches_host(c):
    a, _ = operands(7)
    got = gf.to_u64(gf.mul_small(gf.from_u64(a), c))
    np.testing.assert_array_equal(got, ref.mul(a, np.full_like(a, c)))


def test_split_and_recombine_halves():
    a, _ = operands(8)
    lo, hi = gf.split_halves(gf.from_u64(a))
    np.testing.assert_array_equal(lo.numpy(), (a & np.uint64(0xFFFFFFFF)).astype(np.int64))
    np.testing.assert_array_equal(hi.numpy(), (a >> np.uint64(32)).astype(np.int64))
    np.testing.assert_array_equal(gf.to_u64(gf.from_halves(hi, lo)), a)
    # the largest halves from_halves takes: sums of many halves, below 2^63
    big = torch.tensor([(1 << 63) - 1, 1 << 62, 0], dtype=torch.int64)
    want = [(int(h) * (1 << 32) + int(lo_)) % P for h, lo_ in zip(big.tolist(), big.flip(0).tolist())]
    assert gf.to_u64(gf.from_halves(big, big.flip(0))).tolist() == want
