"""Goldilocks field arithmetic on torch tensors.

p = 2^64 - 2^32 + 1 and its degree-2 binomial extension X^2 = 7, as in the
JAX package's `fields/gf.py`. torch has no usable unsigned 64-bit
arithmetic, so a base-field array is an `int64` tensor holding the u64 bit
pattern of each canonical element (< p):

  * `+`, `-` and `*` wrap mod 2^64, which is what the u64 formulas need;
  * a logical right shift is `(x >> k) & mask`;
  * an unsigned compare flips the sign bit of both sides first.

Multiplication splits both operands into 32-bit halves, forms the exact
128-bit product (its high word from four 32x32 partial products, its low
word from one wrapping multiply), and reduces it with the
classic reduce128 (2^64 = 2^32 - 1, 2^96 = -1 mod p) -- the native-u64 path
of the JAX package (`gf.py:_mul_u64`). Every op returns canonical values, so
equality of field arrays is equality of tensors.

An extension array is a `GF2` pair of equal-shape base tensors (a0, a1),
meaning a0 + a1*X.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

P = (1 << 64) - (1 << 32) + 1
EPSILON = (1 << 32) - 1  # 2^64 mod p
EXT_W = 7

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def as_i64(v: int) -> int:
    """A u64 python int as the int64 value with the same bit pattern."""
    v %= 1 << 64
    return v - (1 << 64) if v >= 1 << 63 else v


P_I64 = as_i64(P)
_P_FLIPPED = as_i64(P) ^ _SIGN  # p with its sign bit flipped, for x >= p


def _const(v: int) -> torch.Tensor:
    """A 0-dim CPU int64 tensor. torch takes it as a scalar operand on any
    device; a Python int operand would be wrapped into a tensor anew on
    every op, which costs host time on every small op."""
    return torch.tensor(v, dtype=torch.int64)


_K1, _K32, _M32_T, _SIGN_T, _EPS_T, _P_T, _P_FLIPPED_T = (
    _const(v) for v in (1, 32, _M32, _SIGN, EPSILON, P_I64, _P_FLIPPED)
)


def _shr32(x):
    """Logical right shift by 32 of u64 bit patterns held in int64."""
    return torch.bitwise_right_shift(x, _K32) & _M32_T


def _shl32(x):
    return torch.bitwise_left_shift(x, _K32)


def _shl1(x):
    return torch.bitwise_left_shift(x, _K1)


def _flip(x):
    return x ^ _SIGN_T


def _ult(a, b):
    """Unsigned a < b on u64 bit patterns."""
    return _flip(a) < _flip(b)


def _canon_once(x):
    """x - p where x >= p (unsigned), for x < 2p."""
    return torch.where(_flip(x) >= _P_FLIPPED_T, x - _P_T, x)


# ---------------------------------------------------------------------------
# large arrays: a slice at a time
# ---------------------------------------------------------------------------

# An elementwise op over more than CHUNK elements runs a slice at a time
# into one output: a multiply's temporaries are some ten arrays the size of
# its operands, which at the 2^29 entries of a 2^28-row table's codeword
# would not fit beside the arrays themselves.
CHUNK = 1 << 24


def _slices(shape):
    """Index tuples that cut an output of `shape` into pieces of at most
    CHUNK elements: blocks of rows, or pieces of one row of a 2-D shape
    whose rows are longer than CHUNK (None: not cut)."""
    inner = math.prod(shape[1:])
    if inner <= CHUNK:
        step = max(1, CHUNK // max(1, inner))
        return [(slice(r, r + step),) for r in range(0, shape[0], step)]
    if len(shape) != 2:
        return None
    return [(r, slice(c, c + CHUNK)) for r in range(shape[0]) for c in range(0, shape[1], CHUNK)]


def _piece(x, idx, shape):
    """Operand x's part of the output piece idx (x broadcasts to shape)."""
    if isinstance(x, GF2):
        return GF2(_piece(x.a0, idx, shape), _piece(x.a1, idx, shape))
    if not isinstance(x, torch.Tensor) or x.dim() == 0:
        return x
    off = len(shape) - x.dim()
    sel = []
    for d, s in enumerate(idx):
        if d < off:
            continue
        if x.shape[d - off] == 1 and shape[d] != 1:
            sel.append(slice(None) if isinstance(s, slice) else 0)
        else:
            sel.append(s)
    return x[tuple(sel)]


def _numel(x) -> int:
    if isinstance(x, GF2):
        return x.a0.numel()
    return x.numel() if isinstance(x, torch.Tensor) else 1


def _shape(x):
    return x.shape if isinstance(x, (torch.Tensor, GF2)) else ()


def _in_pieces(fn):
    """Run fn (elementwise, base or GF2 operands, a base or GF2 result) a
    CHUNK-sized piece of its output at a time when it is larger."""

    @functools.wraps(fn)
    def run(*args):
        for x in args:
            if _numel(x) > CHUNK:
                break
        else:
            return fn(*args)
        shape = tuple(torch.broadcast_shapes(*(_shape(x) for x in args)))
        pieces = _slices(shape) if shape else None
        if pieces is None:
            return fn(*args)
        first = True
        for idx in pieces:
            part = fn(*(_piece(x, idx, shape) for x in args))
            if first:
                planes = [part.a0, part.a1] if isinstance(part, GF2) else [part]
                outs = [torch.empty(shape, dtype=torch.int64, device=planes[0].device) for _ in planes]
                first = False
            for o, v in zip(outs, [part.a0, part.a1] if isinstance(part, GF2) else [part]):
                o[idx] = v
        return GF2(*outs) if len(outs) == 2 else outs[0]

    return run


# ---------------------------------------------------------------------------
# base field
# ---------------------------------------------------------------------------


@_in_pieces
def add(a, b):
    """a + b mod p; `b` may be a tensor or a canonical python int."""
    if isinstance(b, int):
        b, pmb = as_i64(b), as_i64(P - b)
    else:
        pmb = _P_T - b  # p - b, in [1, p]
    return torch.where(_ult(a, pmb), a + b, a - pmb)


@_in_pieces
def sub(a, b):
    d = a - b
    return torch.where(_ult(a, b), d + _P_T, d)


@_in_pieces
def neg(a):
    return torch.where(a == 0, a, _P_T - a)


def _split(x):
    if isinstance(x, int):
        return x & _M32, x >> 32
    return x & _M32_T, _shr32(x)


def _reduce128(lo, hi):
    """hi * 2^64 + lo mod p, as a u64 below 2^64 (< 2p, not yet canonical)."""
    hi_hi = _shr32(hi)
    hi_lo = hi & _M32_T
    t0 = lo - hi_hi
    t0 = torch.where(_ult(lo, hi_hi), t0 - _EPS_T, t0)
    t1 = _shl32(hi_lo) - hi_lo  # hi_lo * EPSILON, exact
    t2 = t0 + t1
    return torch.where(_ult(t2, t1), t2 + _EPS_T, t2)


@_in_pieces
def mul(a, b):
    """a * b mod p; `b` may be a tensor or a canonical python int."""
    return _canon_once(mul_lazy(a, b))


def mul_lazy(a, b):
    """a * b mod p as a u64 below 2^64 that may still be >= p: a valid
    operand of another `mul_lazy` or `mul` (any u64 operands), not of
    `add` or `sub`."""
    a_lo, a_hi = _split(a)
    b_lo, b_hi = _split(b)
    ll = a_lo * b_lo
    lh = a_lo * b_hi
    hl = a_hi * b_lo
    hh = a_hi * b_hi
    t = _shr32(ll) + (lh & _M32_T) + (hl & _M32_T)  # < 3 * 2^32
    lo = a * (as_i64(b) if isinstance(b, int) else b)  # the low 64 bits, wrapping
    hi = hh + _shr32(lh) + _shr32(hl) + torch.bitwise_right_shift(t, _K32)
    return _reduce128(lo, hi)


@_in_pieces
def mul_small(a, c: int):
    """a * c mod p for a python int 0 <= c < 2^31: each 32-bit half times
    c stays below 2^63, so `from_halves` reduces it."""
    lo, hi = split_halves(a)
    return from_halves(hi * c, lo * c)


@_in_pieces
def square(a):
    return _canon_once(square_lazy(a))


def square_lazy(a):
    """`mul_lazy(a, a)` with the two equal cross products formed once."""
    a_lo, a_hi = _split(a)
    ll = a_lo * a_lo
    lh = a_lo * a_hi
    t = _shr32(ll) + _shl1(lh & _M32_T)  # < 3 * 2^32
    hi = a_hi * a_hi + _shl1(_shr32(lh)) + torch.bitwise_right_shift(t, _K32)
    return _reduce128(a * a, hi)


def pow_const(a, e: int):
    """a ** e for a python-int exponent (square-and-multiply)."""
    assert e >= 0
    if e == 0:
        return torch.ones_like(a)
    result = None
    base = a
    while e:
        if e & 1:
            result = base if result is None else mul(result, base)
        e >>= 1
        if e:
            base = square(base)
    return result


def inv(a):
    """Field inverse by Fermat; inv(0) = 0."""
    return pow_const(a, P - 2)


def sum_axis(a, dim: int = -1):
    """Modular sum along `dim`.

    Field addition is exact, so any order gives the same canonical sum:
    the 32-bit halves are summed as plain int64 (exact below 2^31 terms)
    and recombined as hi * 2^32 + lo mod p.
    """
    assert a.shape[dim] < (1 << 31)
    lo, hi = split_halves(a)
    return from_halves(hi.sum(dim), lo.sum(dim))


def split_halves(a):
    """(low, high) 32-bit halves of u64 bit patterns, each as an int64 >= 0."""
    return a & _M32_T, _shr32(a)


def from_halves(hi, lo):
    """hi * 2^32 + lo mod p for int64 0 <= hi, lo < 2^63: hi * 2^32 =
    (hi mod 2^32) * 2^32 + (hi >> 32) * 2^64, and 2^64 = EPSILON mod p.
    The first term is at most 2^64 - 2^32 < p and the others are below
    2^63 < p, so all three are canonical."""
    return add(add(_shl32(hi & _M32_T), torch.bitwise_right_shift(hi, _K32) * _EPS_T), lo)


def from_u64(arr, device="cpu") -> torch.Tensor:
    """numpy uint64 (or python ints) -> canonical int64-pattern tensor."""
    a = np.asarray(arr, dtype=np.uint64)
    a = np.where(a >= np.uint64(P), a - np.uint64(P), a)
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(device)


def to_u64(a: torch.Tensor) -> np.ndarray:
    return a.detach().cpu().numpy().view(np.uint64)


def full(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape, as_i64(value % P), dtype=torch.int64, device=device)


def zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# extension field GF(p^2) = F_p[X]/(X^2 - 7)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GF2:
    """Array of GoldilocksExt2 elements a0 + a1*X, X^2 = 7."""

    a0: torch.Tensor
    a1: torch.Tensor

    @property
    def shape(self):
        return tuple(self.a0.shape)

    @property
    def ndim(self):
        return self.a0.ndim

    @property
    def device(self):
        return self.a0.device

    def __len__(self):
        return self.a0.shape[0]

    def __getitem__(self, idx):
        return GF2(self.a0[idx], self.a1[idx])

    def reshape(self, *shape):
        return GF2(self.a0.reshape(*shape), self.a1.reshape(*shape))


@_in_pieces
def ext_add(a: GF2, b: GF2) -> GF2:
    return GF2(add(a.a0, b.a0), add(a.a1, b.a1))


@_in_pieces
def ext_sub(a: GF2, b: GF2) -> GF2:
    return GF2(sub(a.a0, b.a0), sub(a.a1, b.a1))


@_in_pieces
def ext_mul(a: GF2, b: GF2) -> GF2:
    """Karatsuba: 3 base muls + the binomial fold by W = 7."""
    t0 = mul(a.a0, b.a0)
    t1 = mul(a.a1, b.a1)
    t2 = mul(add(a.a0, a.a1), add(b.a0, b.a1))
    return GF2(add(t0, mul_small(t1, EXT_W)), sub(t2, add(t0, t1)))


@_in_pieces
def ext_mul_base(a: GF2, b) -> GF2:
    return GF2(mul(a.a0, b), mul(a.a1, b))


def ext_from_base(a: torch.Tensor) -> GF2:
    return GF2(a, torch.zeros_like(a))


def to_ext(values) -> GF2:
    return values if isinstance(values, GF2) else ext_from_base(values)


def ext_zeros(shape, device) -> GF2:
    return GF2(zeros(shape, device), zeros(shape, device))


def ext_ones(shape, device) -> GF2:
    return GF2(full(shape, 1, device), zeros(shape, device))


def ext_inv(a: GF2) -> GF2:
    """(a0 + a1 X)^-1 = (a0 - a1 X) / (a0^2 - 7 a1^2)."""
    norm = sub(square(a.a0), mul(square(a.a1), EXT_W))
    ninv = inv(norm)
    return GF2(mul(a.a0, ninv), mul(neg(a.a1), ninv))


def ext_powers(a: GF2, k: int) -> GF2:
    """1, a, a^2, ..., a^(k-1) for a GF2 () scalar, as GF2 (k,) on its
    device: by doubling, 2 log2(k) multiplies."""
    out = ext_ones((1,), a.device)
    step = a.reshape(1)
    while out.shape[0] < k:
        out = ext_concatenate([out, ext_mul(out, step)])
        step = ext_mul(step, step)
    return out[:k]


def ext_concatenate(parts, dim: int = 0) -> GF2:
    return GF2(
        torch.cat([p.a0 for p in parts], dim), torch.cat([p.a1 for p in parts], dim)
    )


def ext_stack(parts, dim: int = 0) -> GF2:
    return GF2(
        torch.stack([p.a0 for p in parts], dim),
        torch.stack([p.a1 for p in parts], dim),
    )


def ext_sum_axis(a: GF2, dim: int = -1) -> GF2:
    return GF2(sum_axis(a.a0, dim), sum_axis(a.a1, dim))


def ext_from_pairs(pairs, device) -> GF2:
    """Host ext pairs [(a0, a1), ...] -> GF2 (k,) on `device`."""
    a0 = np.asarray([int(p[0]) % P for p in pairs], dtype=np.uint64)
    a1 = np.asarray([int(p[1]) % P for p in pairs], dtype=np.uint64)
    return GF2(from_u64(a0, device), from_u64(a1, device))


def ext_scalar(pair, device) -> GF2:
    """Host ext pair -> GF2 () on `device`."""
    return ext_from_pairs([pair], device).reshape(())


def ext_to_u64(a: GF2):
    packed = to_u64(torch.stack([a.a0.reshape(-1), a.a1.reshape(-1)]))
    return packed[0].reshape(a.shape), packed[1].reshape(a.shape)


def ext_to_pairs(a: GF2) -> list:
    """GF2 (k,) -> host [(a0, a1), ...] (one pull)."""
    a0, a1 = ext_to_u64(a.reshape(-1))
    return list(zip(a0.tolist(), a1.tolist()))
