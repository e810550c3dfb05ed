"""Native host kernels and the build directory shared by every compiled source.

The Poseidon2 permutation for the host-side transcript and Merkle path
checks is C, compiled with gcc at first use and loaded with ctypes. The
round constants are emitted from `hashing/constants.py` into a header at
build time, so the host C and the CUDA kernel read one source of truth.
Builds land in `BUILD_DIR` inside the package (listed in `.gitignore`),
named by a hash of their inputs.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile

import numpy as np

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")

_LIB = None


def constants_header() -> str:
    """C text of the Poseidon2 round constants.

    `u64` must be defined before inclusion. The arrays are declared with
    the `P2_CONST` qualifier: `static const` by default, and CUDA sources
    define it as `__constant__` so every thread reads them by broadcast."""
    from ..hashing import constants as C

    def row(vals):
        return "{" + ", ".join(f"{v}ULL" for v in vals) + "}"

    return (
        "/* generated from hashing/constants.py - do not edit */\n"
        "#ifndef P2_CONST\n#define P2_CONST static const\n#endif\n"
        "P2_CONST u64 INIT_RC[4][8] = {"
        + ", ".join(row(r) for r in C.INITIAL_EXTERNAL_CONSTANTS)
        + "};\n"
        "P2_CONST u64 TERM_RC[4][8] = {"
        + ", ".join(row(r) for r in C.TERMINAL_EXTERNAL_CONSTANTS)
        + "};\n"
        "P2_CONST u64 INT_RC[22] = " + row(C.INTERNAL_CONSTANTS) + ";\n"
        "P2_CONST u64 DIAG[8] = " + row(C.MATRIX_DIAG_8) + ";\n"
    )


def build_shared_lib(name: str, sources: list[str], compiler_cmd) -> str:
    """Compile `sources` into BUILD_DIR/<name>_<hash>.so once; return its path.

    `compiler_cmd(include_dir, out_path)` gives the command line. The
    constants header is written into `include_dir` as
    `poseidon2_constants.h`. Raises RuntimeError if the build fails.
    """
    header = constants_header()
    h = hashlib.sha256(header.encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(compiler_cmd("I", "O")).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"{name}_{h.hexdigest()[:16]}.so")
    if os.path.exists(so_path):
        return so_path
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        with open(os.path.join(tmp, "poseidon2_constants.h"), "w") as f:
            f.write(header)
        tmp_so = os.path.join(tmp, "lib.so")
        cmd = compiler_cmd(tmp, tmp_so)
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building {name} failed: {' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp_so, so_path)
    return so_path


def get_lib():
    """ctypes handle to the host Poseidon2 library, built at first use."""
    global _LIB
    if _LIB is None:
        src = os.path.join(os.path.dirname(__file__), "poseidon2.c")
        so = build_shared_lib(
            "poseidon2_host",
            [src],
            lambda inc, out: [
                "gcc", "-O3", "-shared", "-fPIC", "-I", inc, "-o", out, src,
            ],
        )
        lib = ctypes.CDLL(so)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.poseidon2_permute_batch.argtypes = [u64p, ctypes.c_size_t]
        lib.poseidon2_permute_batch.restype = None
        lib.poseidon2_compress_batch.argtypes = [u64p, u64p, u64p, ctypes.c_size_t]
        lib.poseidon2_compress_batch.restype = None
        _LIB = lib
    return _LIB


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def permute_batch(states: np.ndarray) -> np.ndarray:
    """Permute every width-8 state of `states` (..., 8) uint64; returns a copy."""
    out = np.array(states, dtype=np.uint64, order="C", copy=True)
    if out.ndim == 0 or out.shape[-1] != 8:
        raise ValueError(f"states must be (..., 8), got {out.shape}")
    get_lib().poseidon2_permute_batch(_ptr(out), out.size // 8)
    return out


def permute_inplace(state: np.ndarray) -> None:
    """Permute ONE contiguous width-8 uint64 state in place."""
    if not (state.dtype == np.uint64 and state.shape == (8,) and state.flags.c_contiguous):
        raise ValueError("state must be a contiguous (8,) uint64 array")
    get_lib().poseidon2_permute_batch(_ptr(state), 1)


def compress_batch(left: np.ndarray, right: np.ndarray) -> np.ndarray:
    """two_to_one over rows: left, right (..., 4) uint64 -> (..., 4)."""
    l = np.ascontiguousarray(left, dtype=np.uint64)
    r = np.ascontiguousarray(right, dtype=np.uint64)
    if l.shape != r.shape or l.ndim == 0 or l.shape[-1] != 4:
        raise ValueError(f"left/right must be equal (..., 4), got {l.shape}, {r.shape}")
    out = np.empty_like(l)
    get_lib().poseidon2_compress_batch(_ptr(l), _ptr(r), _ptr(out), l.size // 4)
    return out
