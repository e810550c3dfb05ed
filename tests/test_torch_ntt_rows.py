"""The port's batched row (i)FFT (`pcs/ntt.py` `fft_rows`, `ifft`,
`subgroup_gen`) against a naive DFT in Python ints and against the JAX
package's `fft_rows`/`ifft` on the same random rows (N = 32, base and
extension rows, forward and inverse). These fix the convolution's
frequency-domain weight commitments, so equality must be exact."""

import numpy as np
import pytest

from deepprove_tpu_torch.fields import gf, host
from deepprove_tpu_torch.pcs import ntt

P = gf.P
LG_N = 5


def _rows(seed, b=3, lg_n=LG_N):
    return np.random.default_rng(seed).integers(0, P, size=(b, 1 << lg_n), dtype=np.uint64)


def _naive_dft(row, w):
    n = len(row)
    return [sum(int(row[k]) * pow(w, t * k, P) for k in range(n)) % P for t in range(n)]


def test_subgroup_gen_has_order_n_and_matches_jax():
    from deepprove_tpu.pcs import ntt as jax_ntt

    for lg_n in (1, 5, 11, 13):
        w = ntt.subgroup_gen(lg_n)
        assert w == jax_ntt.subgroup_gen(lg_n)
        assert pow(w, 1 << lg_n, P) == 1 and pow(w, 1 << (lg_n - 1), P) == P - 1


@pytest.mark.parametrize("inverse", [False, True], ids=["fft", "ifft"])
def test_fft_rows_match_naive_dft(inverse):
    rows = _rows(41)
    w = ntt.subgroup_gen(LG_N)
    got = gf.to_u64(ntt.fft_rows(gf.from_u64(rows), inverse=inverse)).tolist()
    if inverse:
        w_inv, n_inv = pow(w, P - 2, P), pow(1 << LG_N, P - 2, P)
        want = [[v * n_inv % P for v in _naive_dft(r, w_inv)] for r in rows]
    else:
        want = [_naive_dft(r, w) for r in rows]
    assert got == want


def test_ifft_inverts_fft_and_matches_rows():
    rows = _rows(42)
    x = gf.from_u64(rows)
    back = ntt.fft_rows(ntt.fft_rows(x), inverse=True)
    assert gf.to_u64(back).tolist() == rows.tolist()
    one = gf.from_u64(rows[0])
    assert gf.to_u64(ntt.ifft(ntt.fft(one))).tolist() == rows[0].tolist()
    assert gf.to_u64(ntt.ifft(one)).tolist() == gf.to_u64(ntt.fft_rows(x, inverse=True))[0].tolist()


def test_fft_rows_of_extension_rows_act_per_plane():
    a0, a1 = _rows(43), _rows(44)
    got = ntt.fft_rows(gf.GF2(gf.from_u64(a0), gf.from_u64(a1)), inverse=True)
    assert gf.to_u64(got.a0).tolist() == gf.to_u64(ntt.fft_rows(gf.from_u64(a0), inverse=True)).tolist()
    assert gf.to_u64(got.a1).tolist() == gf.to_u64(ntt.fft_rows(gf.from_u64(a1), inverse=True)).tolist()


@pytest.mark.parametrize("inverse", [False, True], ids=["fft", "ifft"])
def test_fft_rows_match_jax(inverse):
    from deepprove_tpu.fields import gf as jgf
    from deepprove_tpu.pcs import ntt as jax_ntt

    rows = _rows(45)
    want = jgf.to_u64(jax_ntt.fft_rows(jgf.from_u64(rows), inverse=inverse))
    got = gf.to_u64(ntt.fft_rows(gf.from_u64(rows), inverse=inverse))
    np.testing.assert_array_equal(got, np.asarray(want))
    if inverse:
        want1 = jgf.to_u64(jax_ntt.ifft(jgf.from_u64(rows[1])))
        np.testing.assert_array_equal(gf.to_u64(ntt.ifft(gf.from_u64(rows[1]))), np.asarray(want1))


def test_inverse_root_rows_are_the_inverses_of_the_forward_rows():
    for fwd, inv in zip(ntt._root_rows_host(LG_N), ntt._root_rows_host(LG_N, inverse=True)):
        assert host.mul(fwd, inv).tolist() == [1] * len(fwd)
