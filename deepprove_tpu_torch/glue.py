"""Device-resident claims and the one-pull proof materializer.

Claims and proof values stay on the device while a prove runs; the
proof tree is lowered to host ints in ONE device-to-host copy at the end
(`materialize`), into the same nested plain-int structure as the JAX
package's `glue.materialize`: GF2 () -> pair, (n,) -> [pairs],
(n, m) -> [[pairs]]; base () -> int, (n,) -> [ints]; `NpGF` -> numpy
uint64 array; a `Deferred` node -> what its `build` function makes of
its lowered leaves (the Basefold query openings).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fields import gf
from .fields.gf import GF2


@dataclasses.dataclass
class DevClaim:
    """Claim{point, eval} with device values: point GF2 (n,), eval GF2 ()."""

    point: GF2
    eval: GF2


def at(arr: GF2, i: int) -> GF2:
    return arr[i]


_INDEX: dict = {}


def index_tensor(idxs, device) -> torch.Tensor:
    """A list of indices as an int64 tensor on `device`, made once per list
    (a copy from pageable host memory waits for the device)."""
    key = (tuple(idxs), str(device))
    if key not in _INDEX:
        _INDEX[key] = torch.tensor(key[0], dtype=torch.int64).to(device)
    return _INDEX[key]


def take(arr: GF2, idxs) -> GF2:
    """arr[idxs] for a GF2 (m,) array and a list of indices."""
    ii = index_tensor(idxs, arr.device)
    return GF2(arr.a0[ii], arr.a1[ii])


def concat_points(parts) -> GF2:
    """Concatenate point arrays (n,) and scalars () into one (n,) array."""
    return gf.ext_concatenate([p.reshape(1) if p.ndim == 0 else p for p in parts])


@dataclasses.dataclass
class NpGF:
    """Marker: materialize this base array (any ndim) as numpy uint64."""

    arr: torch.Tensor


@dataclasses.dataclass
class Deferred:
    """Marker: lower `leaves` (any tree of device values) with everything
    else, then replace this node with `build(host leaves)`."""

    leaves: object
    build: object


class _Pending:
    __slots__ = ("idx",)

    def __init__(self, idx: int):
        self.idx = idx


class _PendingDeferred:
    __slots__ = ("leaves", "build")

    def __init__(self, leaves, build):
        self.leaves = leaves
        self.build = build


class _PendingClaim:
    __slots__ = ("point", "eval")

    def __init__(self, point, eval_):
        self.point = point
        self.eval = eval_


_DESCEND = object()


def _map(obj, fn, seen):
    """Rebuild `obj`, replacing every node for which `fn(node, recurse)`
    returns something other than `_DESCEND`. Non-frozen dataclasses, lists
    and dicts are updated in place; tuples are rebuilt."""
    out = fn(obj, lambda x: _map(x, fn, seen))
    if out is not _DESCEND:
        return out
    if isinstance(obj, tuple):
        return tuple(_map(v, fn, seen) for v in obj)
    is_dc = dataclasses.is_dataclass(obj) and not isinstance(obj, type)
    if not (isinstance(obj, (list, dict)) or (is_dc and not obj.__dataclass_params__.frozen)):
        return obj
    if id(obj) in seen:
        return obj
    seen.add(id(obj))
    if isinstance(obj, list):
        obj[:] = [_map(v, fn, seen) for v in obj]
    elif isinstance(obj, dict):
        for k in list(obj):
            obj[k] = _map(obj[k], fn, seen)
    else:
        for f in dataclasses.fields(obj):
            setattr(obj, f.name, _map(getattr(obj, f.name), fn, seen))
    return obj


def _host_value(kind: str, v):
    if kind == "np":
        return v.copy()
    if kind == "base":
        return int(v) if v.ndim == 0 else v.tolist()
    a0, a1 = v
    if a0.ndim == 0:
        return (int(a0), int(a1))
    if a0.ndim == 1:
        return list(zip(a0.tolist(), a1.tolist()))
    if a0.ndim == 2:
        return [list(zip(r0, r1)) for r0, r1 in zip(a0.tolist(), a1.tolist())]
    raise ValueError(f"GF2 ndim {a0.ndim} unsupported")


def materialize(root):
    """Pull every device leaf of `root` in ONE copy and replace it with host
    ints (see the module docstring). Returns the new root."""
    from .lookup.logup import Claim

    leaves: list = []

    def collect(obj, recurse):
        if isinstance(obj, NpGF):
            leaves.append(("np", obj.arr))
        elif isinstance(obj, GF2):
            leaves.append(("ext", obj))
        elif isinstance(obj, torch.Tensor):
            leaves.append(("base", obj))
        elif isinstance(obj, DevClaim):
            return _PendingClaim(recurse(obj.point), recurse(obj.eval))
        elif isinstance(obj, Deferred):
            return _PendingDeferred(recurse(obj.leaves), obj.build)
        else:
            return _DESCEND
        return _Pending(len(leaves) - 1)

    root = _map(root, collect, set())
    flat = []
    for kind, obj in leaves:
        flat += [obj.a0, obj.a1] if kind == "ext" else [obj]
    pulled = gf.to_u64(torch.cat([t.reshape(-1) for t in flat])) if flat else None

    values = []
    off = 0
    for kind, obj in leaves:
        shape = tuple(obj.shape)
        n = int(np.prod(shape, dtype=np.int64))
        parts = 2 if kind == "ext" else 1
        chunks = [
            pulled[off + k * n : off + (k + 1) * n].reshape(shape) for k in range(parts)
        ]
        off += parts * n
        values.append(_host_value(kind, chunks if kind == "ext" else chunks[0]))

    def resolve(obj, recurse):
        if isinstance(obj, _Pending):
            return values[obj.idx]
        if isinstance(obj, _PendingClaim):
            return Claim(point=recurse(obj.point), eval=recurse(obj.eval))
        if isinstance(obj, _PendingDeferred):
            return obj.build(recurse(obj.leaves))
        return _DESCEND

    return _map(root, resolve, set())
