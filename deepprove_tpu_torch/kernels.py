"""The port's CUDA kernel library: `csrc/kernels.cu`, one translation unit
that includes every source of `csrc/`:

  * `poseidon2_compress.cu` - the Merkle level (`hashing/poseidon2_cuda.py`);
  * `transcript.cu` - the Fiat-Shamir sponge (`transcript/device.py`);
  * `sumcheck.cu` - the sumcheck rounds (`sumcheck/fused.py`).

It is built by one nvcc call for sm_90a at first use into the package's
build directory (`native.BUILD_DIR`, named by a hash of its inputs) and
loaded once with ctypes; each module binds the entry points of its kernels.
The library holds plain C entry points only (no PyTorch headers), so nvcc
takes seconds.
"""

from __future__ import annotations

import ctypes
import os
import shutil

from . import native

CSRC = os.path.join(os.path.dirname(__file__), "csrc")
SOURCE = os.path.join(CSRC, "kernels.cu")
# every file the translation unit includes: a change to any rebuilds it
INPUTS = [SOURCE] + [
    os.path.join(CSRC, f)
    for f in ("poseidon2_compress.cu", "transcript.cu", "sumcheck.cu",
              "goldilocks.cuh", "poseidon2.cuh", "transcript.cuh")
]

_LIB = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found; the CUDA kernels cannot be built")
    return path


def nvcc_command(include_dir: str, out_path: str) -> list[str]:
    """The nvcc command line that `native.build_shared_lib` runs."""
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-I", include_dir, "-I", CSRC,
        "-o", out_path, SOURCE,
    ]


def build() -> str:
    """Build (or find) the library; returns the .so path."""
    return native.build_shared_lib("deepprove_cuda", INPUTS, nvcc_command)


def library() -> ctypes.CDLL:
    """The loaded library (built at first use)."""
    global _LIB
    if _LIB is None:
        _LIB = ctypes.CDLL(build())
    return _LIB


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        fn = library().dp_cuda_error_string
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{what} failed: " + fn(err).decode())
