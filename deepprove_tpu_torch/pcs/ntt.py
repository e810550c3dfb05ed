"""Goldilocks NTT, Reed-Solomon encoding and hypercube interpolation (torch).

The same transforms as the JAX package's `pcs/ntt.py` (the reference's
plonky2-derived radix-2 DIT FFT, bit-reversed input order, per-stage
precomputed root rows): each butterfly stage runs over a (groups, m) view
of the whole array. Root rows and bit-reversal permutations are computed
on the host once per size and cached per device.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..fields import gf, host
from ..fields.gf import GF2


@lru_cache(maxsize=None)
def bit_reverse_perm(lg_n: int) -> np.ndarray:
    """Permutation j -> reverse_bits(j, lg_n)."""
    n = 1 << lg_n
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(lg_n):
        rev |= ((idx >> b) & 1) << (lg_n - 1 - b)
    return rev


_DEVICE_CACHE: dict = {}


def _on_device(key, device, make):
    """The constant `make()` on `device`, made once and cached."""
    k = (key, str(device))
    if k not in _DEVICE_CACHE:
        _DEVICE_CACHE[k] = make()
    return _DEVICE_CACHE[k]


def _perm(lg_n: int, device) -> torch.Tensor:
    return _on_device(
        ("bitrev", lg_n), device,
        lambda: torch.from_numpy(bit_reverse_perm(lg_n)).to(device),
    )


# Above this size a bit reversal takes two small permutations instead of one
# of its own length (a 2^29-entry index would be 4 GiB, cached).
_DIRECT_REVERSE_LOG = 20


def bit_reverse(values, lg_n: int):
    """values[rev(i)] along the only axis, base tensor or GF2. A large array
    is a (2^a, 2^b) matrix V of its high and low bits, and its reversal is
    V^T with its rows permuted by rev_b and its columns by rev_a."""
    if lg_n <= _DIRECT_REVERSE_LOG:
        perm = _perm(lg_n, values.device)
        return _map_planes(values, lambda p: p[perm])
    a = lg_n // 2
    b = lg_n - a
    rows, cols = _perm(b, values.device), _perm(a, values.device)
    return _map_planes(values, lambda p: p.reshape(1 << a, 1 << b).T[rows][:, cols].reshape(-1))


def geom_powers(g, n: int) -> np.ndarray:
    """[1, g, g^2, ..., g^(n-1)] via vectorized doubling."""
    out = np.ones(n, dtype=np.uint64)
    if n == 1:
        return out
    out[1] = np.uint64(g)
    filled = 2
    while filled < n:
        step = host.pow_const(np.uint64(g), filled)
        take = min(filled, n - filled)
        out[filled : filled + take] = host.mul(out[:take], step)
        filled *= 2
    return out


@lru_cache(maxsize=None)
def _root_rows_host(lg_n: int, inverse: bool = False) -> tuple:
    """Root-table rows: row lg_m-1 = first half powers of the 2^lg_m-th root
    of unity (of its inverse for the inverse transform), length
    max(half_m, 2)."""
    g = host.pow_const(np.uint64(host.TWO_ADIC_GENERATOR), 1 << (host.TWO_ADICITY - lg_n))
    bases = [host.pow_const(g, host.P - 2) if inverse else g]
    for _ in range(1, lg_n):
        bases.append(host.mul(bases[-1], bases[-1]))
    rows = []
    for lg_m in range(1, lg_n + 1):
        half_m = 1 << (lg_m - 1)
        rows.append(geom_powers(bases[lg_n - lg_m], max(half_m, 2)))
    return tuple(rows)


# The transforms' constants (root rows, coset shifts, fold coefficients) are
# made on the device; up to this size they are cached, above it made at each
# use (constants of 2^28 entries would hold GiB).
CACHED_CONSTANTS_LOG = 22


def device_constant(key, lg_n: int, device, make):
    """`make()` on `device`, cached when lg_n <= CACHED_CONSTANTS_LOG."""
    if lg_n <= CACHED_CONSTANTS_LOG:
        return _on_device(key, device, make)
    return make()


def powers_device(g: int, n: int, device) -> torch.Tensor:
    """[1, g, g^2, ..., g^(n-1)] on `device`, by doubling."""
    out = torch.ones(1, dtype=torch.int64, device=device)
    step = int(g) % host.P
    while out.shape[0] < n:
        out = torch.cat([out, gf.mul(out, step)])
        step = step * step % host.P
    return out[:n]


def _root_rows(lg_n: int, device, inverse: bool = False) -> list:
    """Stage m's row is the first 2^(m-1) powers of the 2^m-th root of
    unity: every 2^(n-m)-th entry of the last stage's row."""

    def make():
        g = host.pow_const(np.uint64(host.TWO_ADIC_GENERATOR), 1 << (host.TWO_ADICITY - lg_n))
        if inverse:
            g = host.pow_const(g, host.P - 2)
        last = powers_device(int(g), 1 << max(lg_n - 1, 0), device)
        return [last[:: 1 << (lg_n - lg_m)] for lg_m in range(1, lg_n + 1)]

    return device_constant(("roots", lg_n, inverse), lg_n, device, make)


def subgroup_gen(lg_n: int) -> int:
    """Generator of the order-2^lg_n subgroup."""
    return int(host.pow_const(np.uint64(host.TWO_ADIC_GENERATOR), 1 << (host.TWO_ADICITY - lg_n)))


def _n_inv(lg_n: int) -> int:
    return int(host.pow_const(np.uint64(1 << lg_n), host.P - 2))


@lru_cache(maxsize=None)
def _shift_powers_host(shift: int, n: int) -> np.ndarray:
    return geom_powers(np.uint64(shift), n)


def _map_planes(values, fn):
    if isinstance(values, GF2):
        return GF2(fn(values.a0), fn(values.a1))
    return fn(values)


def _butterflies(values, lg_n: int, rows):
    """DIT stages after bit-reversal; values base or GF2 of length 2^lg_n.
    Each stage writes its halves into one new array (the field ops run a
    piece at a time on large arrays: `gf.CHUNK`)."""
    for lg_m in range(1, lg_n + 1):
        half = 1 << (lg_m - 1)
        om = rows[lg_m - 1][:half]

        def stage(plane):
            v = plane.reshape(-1, 2 * half)
            u = v[:, :half]
            t = gf.mul(v[:, half:], om)
            out = torch.empty_like(v)
            out[:, :half] = gf.add(u, t)
            out[:, half:] = gf.sub(u, t)
            return out.reshape(-1)

        values = _map_planes(values, stage)
    return values


def fft(values, lg_n: int | None = None):
    """Coefficients -> evaluations over the 2^lg_n subgroup (natural order)."""
    if lg_n is None:
        lg_n = values.shape[0].bit_length() - 1
    return _butterflies(bit_reverse(values, lg_n), lg_n, _root_rows(lg_n, values.device))


def ifft(values):
    """Inverse cyclic FFT of one row: y[t] = (1/N) sum_k v[k] omega^(-tk)
    (natural order); `fft_rows` of a single row."""
    return fft_rows(values.reshape(1, -1), inverse=True).reshape(-1)


def fft_rows(values2d, inverse: bool = False):
    """Batched row-wise (i)FFT of a (B, N) base or GF2 array, natural order
    both ways. Every stage runs over all rows at once: a stage's (-1, m)
    view never crosses a row because N is a multiple of m."""
    b, n = values2d.shape
    lg_n = n.bit_length() - 1
    perm = _perm(lg_n, values2d.device)
    flat = _map_planes(values2d, lambda p: p[:, perm].reshape(-1))
    out = _butterflies(flat, lg_n, _root_rows(lg_n, values2d.device, inverse))
    if inverse:
        out = _map_planes(out, lambda p: gf.mul(p, _n_inv(lg_n)))
    return out.reshape(b, n)


def coset_fft(values, shift: int):
    """Evaluations over shift * H: scale by shift powers, then fft."""
    n = values.shape[0]
    lg_n = n.bit_length() - 1
    sp = device_constant(("shift", shift, n), lg_n, values.device,
                         lambda: powers_device(int(shift), n, values.device))
    return fft(_map_planes(values, lambda p: gf.mul(p, sp)), lg_n)


def interpolate_over_hypercube(values):
    """Evaluations over {0,1}^n (little-endian) -> multilinear coefficients:
    per variable, hi -= lo."""
    lg_n = values.shape[0].bit_length() - 1
    for i in range(lg_n):
        half = 1 << i

        def step(plane):
            v = plane.reshape(-1, 2 * half)
            out = v.clone()
            out[:, half:] = gf.sub(v[:, half:], v[:, :half])
            return out.reshape(-1)

        values = _map_planes(values, step)
    return values


def encode_rs(coeffs, full_message_size_log: int, rate_log: int = 1):
    """RS-encode multilinear coeffs at rate 2^-rate_log on the coset
    gamma^2^(full-lg_m) * H. Returns the codeword in natural order."""
    lg_m = coeffs.shape[0].bit_length() - 1
    assert lg_m <= full_message_size_log
    n_out = coeffs.shape[0] << rate_log
    padded = _map_planes(
        coeffs,
        lambda p: torch.cat([p, gf.zeros((n_out - p.shape[0],), p.device)]),
    )
    shift = host.pow_const(
        np.uint64(host.MULTIPLICATIVE_GENERATOR), 1 << (full_message_size_log - lg_m)
    )
    return coset_fft(padded, int(shift))
