"""Dense multilinear extensions over the boolean hypercube (torch).

As in the JAX package's `poly/mle.py`: evaluations are stored in
little-endian index order (variable 0 = lowest index bit); fixing the low
variable folds buf[i] = buf[2i] + r * (buf[2i+1] - buf[2i]); fixing the
high variable folds the two halves. An MLE is a flat base-field int64
tensor or a `GF2` of length 2^n; fixing a base MLE with an extension
challenge yields an extension MLE. Points are `GF2` (n,) arrays, low
variable first; scalars are `GF2` ().
"""

from __future__ import annotations

from ..fields import gf
from ..fields.gf import GF2


def _is_ext(values) -> bool:
    return isinstance(values, GF2)


def fold(lo, hi, r: GF2) -> GF2:
    """lo + r * (hi - lo) for base or ext lo/hi."""
    if _is_ext(lo):
        return gf.ext_add(lo, gf.ext_mul(r, gf.ext_sub(hi, lo)))
    return gf.ext_add(gf.ext_from_base(lo), gf.ext_mul_base(r, gf.sub(hi, lo)))


def fix_variable(values, r: GF2) -> GF2:
    """Bind the lowest variable to r: length 2^n -> GF2 of length 2^(n-1)."""
    return fold(values[0::2], values[1::2], r)


def fix_high_variable(values, r: GF2) -> GF2:
    """Bind the highest variable to r."""
    half = values.shape[0] // 2
    return fold(values[:half], values[half:], r)


def fix_low_variables(values, point: GF2):
    """Bind the lowest len(point) variables, point[0] first."""
    for i in range(point.shape[0]):
        values = fix_variable(values, point[i])
    return values


def fix_high_variables(values, point: GF2):
    """Bind the highest len(point) variables; point[-1] binds the top bit,
    leaving f(., point[0], ..., point[-1]) on the low variables."""
    for i in range(point.shape[0] - 1, -1, -1):
        values = fix_high_variable(values, point[i])
    return values


def evaluate(values, point: GF2) -> GF2:
    """The MLE at an extension point, as a GF2 () scalar."""
    return gf.to_ext(fix_low_variables(values, point)).reshape(())


def eq_table(point: GF2, scale: GF2 | None = None, reverse: bool = False) -> GF2:
    """eq(x, point) over {0,1}^n, little-endian, optionally scaled.

    eq[b] = prod_i (b_i r_i + (1 - b_i)(1 - r_i)). With `reverse`, the
    table comes out in bit-reversed index order, which equals the table
    of the reversed point (eq factorizes per bit)."""
    n = point.shape[0]
    t = gf.ext_ones((1,), point.device) if scale is None else scale.reshape(1)
    order = range(n - 1, -1, -1) if reverse else range(n)
    for i in order:
        hi = gf.ext_mul(t, point[i])
        lo = gf.ext_sub(t, hi)  # t * (1 - r) = t - t * r
        t = gf.ext_concatenate([lo, hi])
    return t
