#!/usr/bin/env python3
"""Measurements behind the sponge's and the sumcheck kernels' designs,
timed on a GPU.

    python3 scripts/tail_designs.py

Builds `scripts/tail_designs.cu` (the port's kernel library in the same
translation unit, and loops around its device functions) with one nvcc
call and prints one JSON line for each part, each with the card's name
and power limit:
  1. `permutation_layouts`: PERMS permutations in turn in one launch, by
     one warp with a state word a lane (the sponge's layout,
     transcript.cuh), by one thread holding all 8 words (the Merkle
     kernel's, poseidon2.cuh), by one warp in the design before the
     finish kernel's redesign, with and without its internal rounds'
     broadcast shuffle, and by the library's layout with its external
     layer gathered in one level of shuffles (the .cu's namespace
     `gather`); each permutation against the host permutation, bit for
     bit; the time a permutation beside its latency bound (112 dependent
     products at chip_smoke.py `product_latencies`' chain_product_ns,
     reported beside its mul_latency_ns);
  2. `finish_share`: the finish kernel at chip_smoke.py's timed shape
     (FINISH_PARTIALS partials of degree 2, and of degree 5) beside its
     partial sum alone and its sponge call alone, for the library's design
     and for the design before it, an empty kernel of one block (the time
     every launch pays), and the library's kernel on 0 and 256 partials;
     every part's outputs equal across the designs and the sums equal the
     host's;
  3. `tail_share`: the library's tail at chip_smoke.py's timed shape (the
     batch opening's last 10 rounds: 126 rows of 2^11, 63 products of
     degree 2) and at its last fused.TAIL_LOG rounds when that differs,
     beside the same rounds' sponge calls alone (one warp, as the tail
     runs them) and the same rounds' grid barriers alone (3 a round): what
     the tail spends besides them is its passes;
  4. `barriers`: 3 x ROUNDS barriers in one launch (the tail's 3 a round),
     for a cluster of 16 and of 8 blocks and for the cooperative grid: the
     barrier's cost a round.
Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import shutil
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))

SRC = os.path.join(ROOT, "scripts", "tail_designs.cu")
PERMS = 600  # permutations a launch
ROUNDS = 1000  # barrier rounds a launch
REPEATS = 20  # launches a timing
FINISH_PARTIALS = 1024  # the finish kernel's timed shape: the batch opening's folding round


def build() -> ctypes.CDLL:
    from deepprove_tpu_torch import kernels, native

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    so = native.build_shared_lib("tail_designs", [SRC] + kernels.INPUTS, lambda inc, out: [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-I", inc, "-I", kernels.CSRC, "-o", out, SRC,
    ])
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.dp_design_permute.argtypes = [i, p, i, p]
    lib.dp_design_barrier.argtypes = [i, i, i, p, ip]
    lib.dp_design_sponge_chain.argtypes = [p, i, p, p, p]
    lib.dp_design_finish.argtypes = [i, i, i, p, ctypes.c_longlong, p, p, p, p, p]
    for fn in (lib.dp_design_permute, lib.dp_design_barrier, lib.dp_design_sponge_chain, lib.dp_design_finish):
        fn.restype = ctypes.c_int
    return lib


def events_ms(fn, repeats: int = REPEATS) -> float:
    """Mean device time of fn() in ms, by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def check(err: int, what: str) -> None:
    from deepprove_tpu_torch import kernels

    kernels.check(err, what)


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def permutation_layouts(lib, cs) -> dict:
    from deepprove_tpu_torch.fields import host
    from deepprove_tpu_torch.transcript import device as devt

    rng = np.random.default_rng(3)
    entry = torch.zeros(devt.STATE_WORDS, dtype=torch.int64)
    entry[:8] = torch.from_numpy(rng.integers(0, host.P, size=8, dtype=np.uint64).view(np.int64))
    # the host permutation PERMS times: a fresh duplex state squeezed once
    # permutes its sponge words once and leaves them canonical
    want = entry.clone()
    for _ in range(PERMS):
        want[12], want[13:], want[17] = 0, 0, 0
        devt.sponge_plain(want, k=1)
    out = {}
    lat = cs.product_latencies()
    layouts = [(0, "warp"), (1, "thread"), (2, "warp_before"), (3, "warp_before_no_broadcast"),
               (4, "gather_external")]
    for layout, name in layouts:
        st = entry.to("cuda")
        check(lib.dp_design_permute(layout, st.data_ptr(), PERMS, stream()), name)
        torch.cuda.synchronize()
        mismatches = int((st.cpu()[:8] != want[:8]).sum())
        ms = events_ms(lambda: lib.dp_design_permute(layout, st.data_ptr(), PERMS, stream()))
        out[name] = {"us_per_permutation": ms * 1e3 / PERMS}
        if layout != 3:  # that one leaves the broadcast out: its values are not the permutation's
            out[name]["mismatches"] = mismatches
    return {"part": "permutation_layouts", "permutations_per_launch": PERMS, **lat,
            "bound_us_per_permutation": 112 * lat["chain_product_ns"] * 1e-3, **out,
            "card": cs.nvidia_smi("name,power.limit")}


def finish_share(lib, cs, degree: int) -> dict:
    """The finish kernel and its parts at FINISH_PARTIALS random partials,
    device times from the profiler's records: the library's kernel (through
    its wrapper) and the design before it, each beside its partial sum alone
    and its sponge call alone (on the first partial row's words); an empty
    kernel of one block; the library's kernel on fewer partials."""
    from deepprove_tpu_torch.fields import host
    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    V = 2 * (degree + 1)
    rng = np.random.default_rng(9)
    words = rng.integers(0, host.P, size=(FINISH_PARTIALS, V), dtype=np.uint64)
    partials = torch.from_numpy(words.reshape(-1).view(np.int64)).to("cuda")
    want_sum = [int(sum(int(v) for v in words[:, k]) % host.P) for k in range(V)]
    entry = DeviceTranscript.from_host(BasicTranscript(b"designs"), "cuda").state

    def run(before: int, part: int):
        """(launch, outputs) of one part on a fresh copy of the entry state."""
        st = entry.clone()
        msgs = torch.zeros((2, 1, degree + 1), dtype=torch.int64, device="cuda")
        chals = torch.zeros((2, 1), dtype=torch.int64, device="cuda")
        out = torch.zeros(V, dtype=torch.int64, device="cuda")
        if before or part:
            launch = lambda: check(lib.dp_design_finish(before, part, degree, partials.data_ptr(), FINISH_PARTIALS,
                                                        msgs.data_ptr(), chals.data_ptr(), st.data_ptr(),
                                                        out.data_ptr(), stream()), "finish part")
        else:
            launch = lambda: fused.finish_cuda(partials, FINISH_PARTIALS, 0, 1, msgs, chals, st, degree)
        launch()
        torch.cuda.synchronize()
        outputs = (st.cpu().clone(), msgs.cpu().clone(), chals.cpu().clone(), out.cpu().clone())
        return launch, outputs

    result, outs = {}, {}
    kernel_names = {0: "finish_kernel", 1: "sum_kernel", 2: "sponge_call_kernel"}
    for before, design in ((0, "library"), (1, "before")):
        times = {}
        for label, part in (("whole", 0), ("partial_sum_alone", 1), ("sponge_call_alone", 2)):
            launch, outs[design, part] = run(before, part)
            times[f"{label}_us"] = cs.device_ms(launch, 50, kernel_names[part]) * 1e3
        times["whole_less_parts_us"] = (times["whole_us"] - times["partial_sum_alone_us"]
                                        - times["sponge_call_alone_us"])
        result[design] = times
    result["empty_kernel_us"] = cs.device_ms(run(0, 3)[0], 50, "empty_kernel") * 1e3
    for nb in (0, 256):  # the library's kernel with fewer partials: the sum's share by its loads
        st = entry.clone()
        msgs = torch.zeros((2, 1, degree + 1), dtype=torch.int64, device="cuda")
        chals = torch.zeros((2, 1), dtype=torch.int64, device="cuda")
        result[f"library_whole_at_{nb}_partials_us"] = cs.device_ms(
            lambda: fused.finish_cuda(partials, nb, 0, 1, msgs, chals, st, degree), 50, "finish_kernel") * 1e3
    sums_ok = all([int(v) for v in outs[d, 1][3].numpy().view(np.uint64)] == want_sum for d in ("library", "before"))
    same = all(all(torch.equal(a, b) for a, b in zip(outs["library", p], outs["before", p])) for p in (0, 2))
    return {"part": "finish_share", "degree": degree, "partials": FINISH_PARTIALS,
            "permutations": cs.sponge_permutations(V + 2, 2), **result,
            "sums_equal_host": sums_ok, "designs_agree": same, "card": cs.nvidia_smi("name,power.limit")}


def grid_barriers_ms(lib, rounds: int) -> float:
    """rounds x 3 grid barriers over the whole card, device ms a launch."""
    used = ctypes.c_int()
    check(lib.dp_design_barrier(1, 0, rounds, stream(), ctypes.byref(used)), "grid barriers")
    return events_ms(lambda: lib.dp_design_barrier(1, 0, rounds, stream(), ctypes.byref(used)))


def tail_share(lib, cs, rounds: int) -> dict:
    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    n, rows, products, degree = cs.sumcheck_cases()["batch_open_2^20"]
    tail_len = 1 << (rounds + 1)
    vp = cs.random_vp(rounds + 1, rows, products, 7, "cuda")  # rows of tail_len
    (s0, s1) = fused.stack_planes(vp).first
    m = rows
    fidx, coeffs = fused.factor_index(vp, degree, "cuda"), fused.coefficients(vp, "cuda")
    chals = torch.randint(0, 1 << 62, (2, n), dtype=torch.int64, device="cuda")  # canonical
    state = DeviceTranscript.from_host(BasicTranscript(b"designs"), "cuda").state
    words, other = fused.row_words(m, tail_len, n - rounds - 1, "cuda")
    half = torch.empty((2, other), dtype=torch.int64, device="cuda")
    msgs = torch.zeros((2, n, degree + 1), dtype=torch.int64, device="cuda")
    finals = torch.empty((2, m), dtype=torch.int64, device="cuda")
    # the work does not depend on the values: the tail runs again on what it left
    tail_ms = events_ms(lambda: fused.tail_cuda((s0, s1), (half[0], half[1]), words, m, tail_len, n - rounds, n,
                                                fidx, coeffs, msgs, chals, state, finals, degree))
    chain_msgs = torch.zeros((2, rounds, 3), dtype=torch.int64, device="cuda")
    chain_chals = torch.zeros((2, rounds), dtype=torch.int64, device="cuda")
    sponge_ms = events_ms(lambda: lib.dp_design_sponge_chain(state.data_ptr(), rounds, chain_msgs.data_ptr(),
                                                             chain_chals.data_ptr(), stream()))
    barriers_ms = grid_barriers_ms(lib, rounds)
    return {"part": "tail_share", "rows": m, "row_length": tail_len, "rounds": rounds,
            "products": len(products), "degree": degree, "grid": fused.tail_config(degree),
            "tail_ms": tail_ms, "sponge_calls_alone_ms": sponge_ms, "grid_barriers_alone_ms": barriers_ms,
            "passes_ms": tail_ms - sponge_ms - barriers_ms, "card": cs.nvidia_smi("name,power.limit")}


def barriers(lib, cs) -> dict:
    out = {}
    for name, (variant, blocks) in {"cluster_16": (0, 16), "cluster_8": (0, 8), "grid": (1, 0)}.items():
        used = ctypes.c_int()
        err = lib.dp_design_barrier(variant, blocks, ROUNDS, stream(), ctypes.byref(used))
        torch.cuda.synchronize()
        if err:
            out[name] = {"refused": err}
            continue
        ms = events_ms(lambda: lib.dp_design_barrier(variant, blocks, ROUNDS, stream(), ctypes.byref(used)), 5)
        out[name] = {"us_per_round": ms * 1e3 / ROUNDS, "blocks": used.value}
    return {"part": "barriers", "barriers_per_round": 3, "rounds_per_launch": ROUNDS, **out,
            "card": cs.nvidia_smi("name,power.limit")}


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_designs: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from deepprove_tpu_torch.sumcheck import fused

    lib = build()
    print(json.dumps(permutation_layouts(lib, cs)), flush=True)
    for degree in (2, 5):
        print(json.dumps(finish_share(lib, cs, degree)), flush=True)
    for rounds in sorted({cs.TIMED_TAIL_ROUNDS, fused.TAIL_LOG}):
        print(json.dumps(tail_share(lib, cs, rounds)), flush=True)
    print(json.dumps(barriers(lib, cs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
