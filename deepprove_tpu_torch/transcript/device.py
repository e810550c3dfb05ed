"""The duplex Fiat-Shamir sponge with its state in a tensor, as in the JAX
package's `transcript/device.py`.

The state is one int64 tensor of 18 entries holding u64 bit patterns:
sponge[0:8], ibuf[8:12], ilen at 12, obuf[13:17], olen at 17 (`export_state`
and `import_state` move it to and from the host `DuplexChallenger`). Entries
of ibuf at or past ilen are zero; obuf keeps its popped entries.

`sponge(state, ...)` applies one call of the transcript session in place:
absorb constants, then a base or extension array (a0 then a1 for each
element), then squeeze k extension challenges with a label absorbed before
each one if asked. On a CUDA state it launches `csrc/transcript.cu` (one
thread; the permutation is a chain of dependent multiplies) and raises if
the kernel cannot run; on a CPU state it runs `sponge_plain`, the same duplex
over the tensor's memory with the native host permutation
(`native/poseidon2.c`), since an eager torch permutation costs thousands of
small ops. No PyTorch call computes Poseidon2.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels, native
from ..fields import gf
from ..fields.gf import GF2
from .challenger import DuplexChallenger

RATE = 4
STATE_WORDS = 18
MAX_PRE = 16  # constants one launch absorbs by value (csrc/transcript.cu)
_ILEN, _OLEN = 12, 17

# Launches of the sponge kernel since the last reset (plain int; callers reset).
LAUNCHES = 0

_LIB = None
_LIMITS = None


def export_state(ch: DuplexChallenger, device) -> torch.Tensor:
    """Host challenger -> state tensor on `device`."""
    s = np.zeros(STATE_WORDS, dtype=np.uint64)
    s[0:8] = ch.state
    s[8 : 8 + len(ch.input_buffer)] = ch.input_buffer
    s[_ILEN] = len(ch.input_buffer)
    s[13 : 13 + len(ch.output_buffer)] = ch.output_buffer
    s[_OLEN] = len(ch.output_buffer)
    return torch.from_numpy(s.view(np.int64)).to(device)


def import_state(ch: DuplexChallenger, state) -> None:
    """State (a tensor, or its host uint64 copy) -> host challenger, in place."""
    s = gf.to_u64(state) if isinstance(state, torch.Tensor) else np.asarray(state, dtype=np.uint64)
    ilen, olen = int(s[_ILEN]), int(s[_OLEN])
    ch.state = s[0:8].copy()
    ch.input_buffer = [int(v) for v in s[8 : 8 + ilen]]
    ch.output_buffer = [int(v) for v in s[13 : 13 + olen]]


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


class _Sponge:
    """The duplex over a uint64 view of a CPU state tensor (no copy)."""

    def __init__(self, words: np.ndarray):
        self.w = words
        self.ilen = int(words[_ILEN])
        self.olen = int(words[_OLEN])

    def duplex(self):
        w = self.w
        w[0 : self.ilen] = w[8 : 8 + self.ilen]
        w[8:12] = 0
        native.permute_inplace(w[0:8])
        w[13:17] = w[0:4]
        self.ilen, self.olen = 0, RATE

    def observe(self, v: int):
        self.w[8 + self.ilen] = v
        self.ilen += 1
        self.olen = 0
        if self.ilen == RATE:
            self.duplex()

    def sample(self) -> int:
        if self.ilen or not self.olen:
            self.duplex()
        self.olen -= 1
        return int(self.w[13 + self.olen])

    def close(self):
        self.w[_ILEN] = self.ilen
        self.w[_OLEN] = self.olen


def _host_values(arr) -> list:
    """A base tensor or GF2 -> its canonical u64 ints in absorb order."""
    if isinstance(arr, GF2):
        a0, a1 = gf.ext_to_u64(arr.reshape(-1))
        return np.stack([a0, a1], axis=1).reshape(-1).tolist()
    return gf.to_u64(arr.reshape(-1)).tolist()


def sponge_plain(state: torch.Tensor, pre=(), arr=None, labels=(), k: int = 0) -> GF2:
    """The sponge call on a CPU state tensor, in place; `arr` may lie on any
    device (it is copied to the host). Returns the k challenges as GF2 (k,)
    on the CPU."""
    if state.device.type != "cpu":
        raise ValueError(f"the plain sponge takes a CPU state, got {state.device}")
    sp = _Sponge(state.numpy().view(np.uint64))
    for v in pre:
        sp.observe(v)
    if arr is not None:
        for v in _host_values(arr):
            sp.observe(v)
    out = np.zeros((2, k), dtype=np.uint64)
    for q in range(k):
        if labels:
            for c in labels[0 if len(labels) == 1 else q]:
                sp.observe(c)
        out[0, q] = sp.sample()
        out[1, q] = sp.sample()
    sp.close()
    t = torch.from_numpy(out.view(np.int64))
    return GF2(t[0], t[1])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _lib():
    global _LIB, _LIMITS
    if _LIB is None:
        lib = kernels.library()
        p = ctypes.c_void_p
        lib.dp_sponge.argtypes = [
            p, p, ctypes.c_int, p, p, ctypes.c_int, p, p, ctypes.c_longlong,
            ctypes.c_longlong, p, p,
        ]
        lib.dp_sponge.restype = ctypes.c_int
        lims = [ctypes.c_int() for _ in range(3)]
        lib.dp_sponge_limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        lib.dp_sponge_limits.restype = None
        lib.dp_sponge_limits(*(ctypes.byref(x) for x in lims))
        _LIMITS = tuple(x.value for x in lims)
        if _LIMITS[0] != MAX_PRE:
            raise RuntimeError(f"transcript.cu takes {_LIMITS[0]} constants a launch, the wrapper {MAX_PRE}")
        _LIB = lib
    return _LIB


def _planes(arr, device):
    """(a0, a1 or None, n) contiguous int64 planes of a base tensor or GF2."""
    if isinstance(arr, GF2):
        a0, a1 = arr.a0.reshape(-1).contiguous(), arr.a1.reshape(-1).contiguous()
    else:
        a0, a1 = arr.reshape(-1).contiguous(), None
    for t in (a0, a1):
        if t is not None and (t.device != device or t.dtype != torch.int64):
            raise ValueError(f"absorbed arrays must be int64 on {device}, got {t.dtype} on {t.device}")
    return a0, a1, a0.shape[0]


def sponge_cuda(state: torch.Tensor, pre=(), arr=None, labels=(), k: int = 0) -> GF2:
    """The sponge call on a CUDA state by the kernel; returns GF2 (k,) on the
    state's device."""
    global LAUNCHES
    if state.device.type != "cuda":
        raise ValueError(f"the sponge kernel takes a CUDA state, got {state.device}")
    if state.dtype != torch.int64 or state.shape != (STATE_WORDS,) or not state.is_contiguous():
        raise ValueError("the sponge state must be a contiguous (18,) int64 tensor")
    lib = _lib()
    max_pre, max_labels, max_chunks = _LIMITS
    pre = [int(v) for v in pre]
    chunks = [c for lbl in labels for c in lbl]
    if len(pre) > max_pre or len(labels) > max_labels or len(chunks) > max_chunks:
        raise ValueError("too many constants or label chunks for one sponge launch")
    if len(labels) > 1 and len(labels) != k:
        raise ValueError("distinct labels need one challenge each")
    dev = state.device
    a0 = a1 = None
    n = 0
    if arr is not None:
        a0, a1, n = _planes(arr, dev)
    out = torch.empty((2, k), dtype=torch.int64, device=dev)
    off = np.cumsum([0] + [len(lbl) for lbl in labels]).astype(np.int32)
    pre_c = (ctypes.c_ulonglong * max(1, len(pre)))(*pre)
    chunks_c = (ctypes.c_ulonglong * max(1, len(chunks)))(*chunks)
    off_c = (ctypes.c_int * len(off))(*off.tolist())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_sponge(
            state.data_ptr(), pre_c, len(pre), chunks_c, off_c, len(labels),
            a0.data_ptr() if a0 is not None else None,
            a1.data_ptr() if a1 is not None else None, n, k, out.data_ptr(), stream,
        )
    kernels.check(err, "sponge kernel launch")
    LAUNCHES += 1
    return GF2(out[0], out[1])


def sponge(state: torch.Tensor, pre=(), arr=None, labels=(), k: int = 0) -> GF2:
    """One session call: the kernel on a CUDA state, the plain version on the
    CPU. `pre`: canonical ints; `arr`: a base tensor or GF2 on the state's
    device; `labels`: tuples of label chunks, one for every challenge or one
    for each; returns the k challenges as GF2 (k,)."""
    if state.device.type == "cpu":
        return sponge_plain(state, pre, arr, labels, k)
    return sponge_cuda(state, pre, arr, labels, k)


def mul_chain(x: torch.Tensor, iters: int, order: int = 0) -> None:
    """x[0] <- a chain of `iters` dependent products on x[0] on the card, in
    one thread (`csrc/transcript.cu`): timed, the latency of one dependent
    product. order 0: x[0] * x[1]^iters by Goldilocks multiplies; order 1:
    a permutation's chain in its order, 112 products a permutation (each
    S-box v <- v^2 x[1]^2, each internal round's then v <- v x[1] + x[1]),
    from which the sponge-running kernels' bounds are reckoned; `iters` a
    multiple of 112."""
    if x.device.type != "cuda" or x.dtype != torch.int64 or x.shape != (2,):
        raise ValueError("mul_chain takes a (2,) int64 CUDA tensor")
    if order not in (0, 1) or (order == 1 and iters % 112):
        raise ValueError("mul_chain: order 0, or order 1 with iters a multiple of 112")
    lib = _lib()
    fn = lib.dp_mul_chain
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), iters, order, torch.cuda.current_stream().cuda_stream)
    kernels.check(err, "multiply chain launch")
