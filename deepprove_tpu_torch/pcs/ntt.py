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
    """Host-computed constant `make()` moved to `device` once, cached."""
    k = (key, str(device))
    if k not in _DEVICE_CACHE:
        _DEVICE_CACHE[k] = make()
    return _DEVICE_CACHE[k]


def _perm(lg_n: int, device) -> torch.Tensor:
    return _on_device(
        ("bitrev", lg_n), device,
        lambda: torch.from_numpy(bit_reverse_perm(lg_n)).to(device),
    )


def bit_reverse(values, lg_n: int):
    """values[rev(i)] along the only axis, base tensor or GF2."""
    perm = _perm(lg_n, values.device)
    if isinstance(values, GF2):
        return GF2(values.a0[perm], values.a1[perm])
    return values[perm]


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


def _root_rows(lg_n: int, device, inverse: bool = False) -> list:
    return _on_device(
        ("roots", lg_n, inverse), device,
        lambda: [gf.from_u64(r, device) for r in _root_rows_host(lg_n, inverse)],
    )


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
    """DIT stages after bit-reversal; values base or GF2 of length 2^lg_n."""
    for lg_m in range(1, lg_n + 1):
        half = 1 << (lg_m - 1)
        om = rows[lg_m - 1][:half]

        def stage(plane):
            v = plane.reshape(-1, 2 * half)
            u = v[:, :half]
            t = gf.mul(v[:, half:], om)
            return torch.cat([gf.add(u, t), gf.sub(u, t)], dim=1).reshape(-1)

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
    sp = _on_device(
        ("shift", shift, n), values.device,
        lambda: gf.from_u64(_shift_powers_host(int(shift), n), values.device),
    )
    return fft(_map_planes(values, lambda p: gf.mul(p, sp)), lg_n)


def interpolate_over_hypercube(values):
    """Evaluations over {0,1}^n (little-endian) -> multilinear coefficients:
    per variable, hi -= lo."""
    lg_n = values.shape[0].bit_length() - 1
    for i in range(lg_n):
        half = 1 << i

        def step(plane):
            v = plane.reshape(-1, 2 * half)
            lo = v[:, :half]
            return torch.cat([lo, gf.sub(v[:, half:], lo)], dim=1).reshape(-1)

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
