"""Merkle-level Poseidon2 compression: the hand-written CUDA kernel and its
plain torch version.

`compress_level` maps a plane-major (4, 2M) int64 digest level (even
columns = left children, odd = right) to its (4, M) parents. On a CUDA
tensor it launches `csrc/poseidon2_compress.cu` (the port of the TPU
kernel `_compress_kernel` in the JAX package's `poseidon2_pallas.py`) and
raises if the kernel cannot run; on a CPU tensor it computes the same
function with the native host permutation (`native/poseidon2.c`, as the
transcript's plain sponge does), since the plain torch version
`compress_level_plain`, which the kernel is held against on the card,
costs thousands of eager ops a level. No single PyTorch call computes
Poseidon2.

The kernel library is built with nvcc for sm_90a at first use into the
package's build directory and bound with ctypes (`kernels.py`). It also carries
`goldilocks_probe`, which runs the kernel's field arithmetic on given
operands so that its lazy (non-canonical) ranges can be checked on the
card against Python ints.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels
from . import poseidon2

# Launches of the CUDA kernel since the last reset (plain int; callers reset).
LAUNCHES = 0

_LIB = None


def build() -> str:
    """Build (or find) the kernel library; returns the .so path."""
    return kernels.build()


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library()
        lib.dp_poseidon2_compress_level.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ]
        lib.dp_poseidon2_compress_level.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def launch_config() -> tuple[int, int]:
    """(threads a block, resident blocks an SM) of the compression kernel on
    the current device, from the CUDA occupancy calculator."""
    lib = _lib()
    fn = lib.dp_poseidon2_launch_config
    fn.argtypes = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    threads, blocks = ctypes.c_int(), ctypes.c_int()
    kernels.check(fn(ctypes.byref(threads), ctypes.byref(blocks)), "occupancy query")
    return threads.value, blocks.value


def _check_level(digests: torch.Tensor) -> int:
    if digests.dtype != torch.int64:
        raise TypeError(f"digest level must be int64, got {digests.dtype}")
    if digests.dim() != 2 or digests.shape[0] != 4:
        raise ValueError(f"digest level must be (4, 2M), got {tuple(digests.shape)}")
    n = digests.shape[1]
    if n == 0 or n % 2:
        raise ValueError(f"digest level width must be even and > 0, got {n}")
    return n // 2


def compress_level_plain(digests: torch.Tensor) -> torch.Tensor:
    """(4, 2M) -> (4, M) parents in plain torch (any device)."""
    _check_level(digests)
    left = [digests[e, 0::2] for e in range(4)]
    right = [digests[e, 1::2] for e in range(4)]
    return torch.stack(poseidon2.compress_planes(left, right))


def compress_level_host(digests: torch.Tensor) -> torch.Tensor:
    """(4, 2M) -> (4, M) parents of a CPU level by the native host
    permutation (canonical digests, as every Merkle level holds)."""
    _check_level(digests)
    level = digests.numpy().view(np.uint64)
    out = poseidon2.compress_host(level[:, 0::2].T, level[:, 1::2].T).T
    return torch.from_numpy(np.ascontiguousarray(out).view(np.int64))


def compress_level_cuda(digests: torch.Tensor) -> torch.Tensor:
    """(4, 2M) -> (4, M) parents by the CUDA kernel (CUDA tensors only)."""
    global LAUNCHES
    m = _check_level(digests)
    if digests.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes a CUDA tensor, got {digests.device}")
    if not digests.is_contiguous():
        raise ValueError("digest level must be contiguous")
    out = torch.empty((4, m), dtype=torch.int64, device=digests.device)
    lib = _lib()
    with torch.cuda.device(digests.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.dp_poseidon2_compress_level(
            digests.data_ptr(), out.data_ptr(), m, stream
        )
    kernels.check(err, "poseidon2 compress kernel launch")
    LAUNCHES += 1
    return out


def compress_level(digests: torch.Tensor) -> torch.Tensor:
    """(4, 2M) -> (4, M): the kernel on a CUDA tensor, the native host
    permutation on the CPU."""
    if digests.device.type == "cpu":
        return compress_level_host(digests)
    return compress_level_cuda(digests)


def goldilocks_probe(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The kernel library's field arithmetic on (N,) int64 CUDA tensors
    holding u64 bit patterns (any in [0, 2^64), not only canonical ones):
    the (4, N) rows a*b, a*b + c, a + c, 7(a + b + c), each mod p, from the
    same `mul`, `mul_add`, `add_const` and unreduced sum + `fold` that the
    compression kernel runs."""
    for t in (a, b, c):
        if t.device.type != "cuda" or t.dtype != torch.int64 or t.dim() != 1:
            raise ValueError("goldilocks_probe takes (N,) int64 CUDA tensors")
        if not t.is_contiguous() or t.shape != a.shape:
            raise ValueError("goldilocks_probe operands must be contiguous and of one shape")
    out = torch.empty((4, a.shape[0]), dtype=torch.int64, device=a.device)
    lib = _lib()
    fn = lib.dp_goldilocks_probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr(), a.shape[0], stream)
    kernels.check(err, "goldilocks probe launch")
    return out
