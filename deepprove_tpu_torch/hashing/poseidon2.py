"""Poseidon2 permutation over Goldilocks, width 8 (host + plain torch).

The same permutation as the JAX package's `hashing/poseidon2.py`: external
linear layer = block-M4 "MDS-light" (M4 = circ(2,3,1,1)), S-box x^7, 4
initial + 4 terminal external rounds, 22 internal rounds with the J + diag(d)
internal matrix applied as state[i]*d[i] + sum(state).

  * host: the native C permutation on numpy uint64 states (..., 8) - the
    sequential transcript and the verifier's Merkle path checks;
  * `permute_planes`: plain torch over 8 separate equal-shape base planes,
    the reference that the CUDA compression kernel is held against
    (`poseidon2_cuda.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..fields import gf
from . import constants as C

_INIT_RC = C.INITIAL_EXTERNAL_CONSTANTS
_TERM_RC = C.TERMINAL_EXTERNAL_CONSTANTS
_INT_RC = C.INTERNAL_CONSTANTS
_DIAG = C.MATRIX_DIAG_8


def permute_host(state: np.ndarray) -> np.ndarray:
    """Poseidon2 permutation; state shape (..., 8) uint64 canonical."""
    return native.permute_batch(np.asarray(state, dtype=np.uint64))


def compress_host(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """Two-to-one Merkle compression over rows (..., 4) uint64."""
    return native.compress_batch(left, right).reshape(np.shape(left))


def _sbox(x):
    x2 = gf.square_lazy(x)
    x4 = gf.square_lazy(x2)
    return gf.mul(gf.mul_lazy(x4, x2), x)


def _mds_light(x):
    """The external linear layer's integer combination on an (8, N) state
    of int64 values without reduction: M4 on each 4-chunk, then each lane
    plus the sum of its column across chunks (coefficients at most 21)."""
    x = x.reshape(2, 4, -1)
    s0, s1, s2, s3 = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    t01 = s0 + s1
    t23 = s2 + s3
    t0123 = t01 + t23
    t01123 = t0123 + s1
    t01233 = t0123 + s3
    y = torch.stack([t01123 + t01, t01123 + 2 * s2, t01233 + t23, t01233 + 2 * s0], dim=1)  # (2, 4, N)
    return (y + (y[0] + y[1])).reshape(8, -1)


def _ext_lin(st):
    """MDS-light on an (8, N) field state: `_mds_light` of the 32-bit
    halves (each combination stays below 21 * 2^32), recombined mod p."""
    lo, hi = gf.split_halves(st)
    return gf.from_halves(_mds_light(hi), _mds_light(lo))


def _lanes(rows, device) -> torch.Tensor:
    """Per-lane constants as an (R, 8, 1) int64 tensor (u64 bit patterns)."""
    return torch.tensor([[[gf.as_i64(v)] for v in row] for row in rows], dtype=torch.int64, device=device)


def permute_planes(s: list) -> list:
    """Poseidon2 over 8 SEPARATE equal-shape int64 planes (plane-major state)."""
    st = _ext_lin(torch.stack(list(s)))
    dev = st.device
    init, term, (diag,) = _lanes(_INIT_RC, dev), _lanes(_TERM_RC, dev), _lanes([_DIAG], dev)
    for rc in init:
        st = _ext_lin(_sbox(gf.add(st, rc)))
    for rc in _INT_RC:
        st = torch.cat([_sbox(gf.add(st[:1], rc)), st[1:]])
        st = gf.add(gf.mul(st, diag), gf.sum_axis(st, 0))
    for rc in term:
        st = _ext_lin(_sbox(gf.add(st, rc)))
    return list(st)


def compress_planes(left: list, right: list) -> list:
    """two_to_one over 4 left and 4 right digest planes -> 4 parent planes.

    Fresh duplex: absorb `left`, permute, overwrite the rate with `right`,
    permute; digest = sample_array::<4>() = [s3, s2, s1, s0]."""
    z = torch.zeros_like(left[0])
    st = permute_planes(list(left) + [z, z, z, z])
    st = permute_planes(list(right) + st[4:])
    return [st[3], st[2], st[1], st[0]]
