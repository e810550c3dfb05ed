#!/usr/bin/env python3
"""What bounds the sumcheck round kernel, timed on a GPU.

    python3 scripts/round_kernel_designs.py

Builds four copies of the port's kernel library, each with its own
`csrc/sumcheck.cu` (one nvcc call each, all started together), and times
their round kernels in turns (a, b, c, d, d, c, b, a) on the same rows:
  - `kernel`: the library's round kernel as it is;
  - `no_prefetch`: without its prefetch of a thread's next unit into L2;
  - `loads_only`: its loads, stores and unit schedule with the field
    products replaced by an exclusive or: the time its bytes take in its
    access pattern;
  - `products_only`: its arithmetic with the row loads replaced by values
    made from the address: the time its integer instructions take.
The shapes: chip_smoke.py's timed one (the batch opening of Dense-4M, 126
rows of 2^20, 63 products of degree 2, its folding round), and the
GPT-2-124M batch opening's rows (tests/torch_reference.py
GPT2_OPENING_CLAIMS, 512 rows of 2^8-2^28, random values) in its first
folding round and in its round 0. Besides: each copy's registers and
spills at every degree (`nvcc -Xptxas -v`), the SASS instructions of its
degree-2 kernel by opcode, the two real copies against the per-round
prover on the ragged and opening shapes (bit for bit), and the rate of a
2 GiB device-to-device copy. Prints one JSON line with the card's name and
power limit. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))

PREFETCH = "unit_pass<D>(it, w - lo, w + nth < hi ? w + nth - lo : -1, fold, r, s0, s1, d0, d1, acc);"
PRODUCT = "u[t] = any ? emul(u[t], v) : v;"
FOLD = ("__device__ __forceinline__ ext fold_by(ext lo, ext hi, const Challenge& c) "
        "{ return eadd(lo, emul_by(c, esub(hi, lo))); }")
LOAD = ("__device__ __forceinline__ ulonglong2 ld16(const u64* p) "
        "{ return __ldg(reinterpret_cast<const ulonglong2*>(p)); }")


def sources() -> dict:
    """Name -> the sumcheck.cu of that copy."""
    with open(os.path.join(ROOT, "deepprove_tpu_torch", "csrc", "sumcheck.cu")) as f:
        src = f.read()
    for part in (PREFETCH, PRODUCT, FOLD, LOAD):
        if src.count(part) != 1:
            raise SystemExit(f"sumcheck.cu no longer holds {part!r} once: update this script")
    loads_only = src.replace(PRODUCT, "u[t] = any ? ext{u[t].a0 ^ v.a0, u[t].a1 + v.a1} : v;").replace(
        FOLD, FOLD.split("{")[0] + "{ return ext{lo.a0 ^ hi.a0 ^ c.r.a0, lo.a1 + hi.a1}; }")
    products_only = src.replace(
        LOAD, LOAD.split("{")[0] + "{ return make_ulonglong2((u64)p >> 4, ((u64)p >> 3) & 0xffffffffULL); }")
    return {"kernel": src, "no_prefetch": src.replace(PREFETCH, PREFETCH.replace("w + nth < hi ? w + nth - lo : -1", "-1")),
            "loads_only": loads_only, "products_only": products_only}


def build(tmp: str) -> tuple[dict, dict]:
    """Name -> library path, and name -> ptxas's lines for its round kernels."""
    from deepprove_tpu_torch import kernels, native

    procs = {}
    for name, src in sources().items():
        d = os.path.join(tmp, name)
        shutil.copytree(kernels.CSRC, d)
        with open(os.path.join(d, "sumcheck.cu"), "w") as f:
            f.write(src)
        with open(os.path.join(d, "poseidon2_constants.h"), "w") as f:
            f.write(native.constants_header())
        cmd = kernels.nvcc_command(d, os.path.join(d, "lib.so"))
        cmd[cmd.index(kernels.SOURCE)] = os.path.join(d, "kernels.cu")
        cmd[cmd.index(kernels.CSRC)] = d
        procs[name] = subprocess.Popen(cmd[:1] + ["-Xptxas", "-v"] + cmd[1:], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, p in procs.items():
        out = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f"building {name} failed:\n{out[-4000:]}")
        lines = out.splitlines()
        found = {}
        for i, ln in enumerate(lines):
            m = re.search(r"round_kernelILi(\d)E", ln)
            if m and "Function properties" in ln:
                regs = re.search(r"Used (\d+) registers", " ".join(lines[i + 1:i + 3]))
                spill = re.search(r"(\d+) bytes spill stores", lines[i + 1])
                found[int(m.group(1))] = {"registers": int(regs.group(1)), "spill_store_bytes": int(spill.group(1))}
        libs[name] = os.path.join(tmp, name, "lib.so")
        ptxas[name] = dict(sorted(found.items()))
    return libs, ptxas


def main() -> int:
    if not torch.cuda.is_available():
        print("round_kernel_designs: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from deepprove_tpu_torch import kernels
    from deepprove_tpu_torch.fields import gf
    from deepprove_tpu_torch.sumcheck import fused

    tmp = tempfile.mkdtemp(prefix="round_designs_")
    try:
        libs, ptxas = build(tmp)
        sass = {}
        for name, so in libs.items():
            ops = collections.Counter(ins.split()[1 if ins.startswith("@") else 0].split(".")[0]
                                      for _, ins in cs.kernel_sass(so, "round_kernelILi2E"))
            sass[name] = {"instructions": sum(ops.values()), "by_opcode": dict(ops.most_common(12))}

        def use(name):
            kernels._LIB = ctypes.CDLL(libs[name])
            fused._LIB = None
            fused._lib()

        x = torch.empty(1 << 28, dtype=torch.int64, device="cuda")
        y = torch.empty_like(x)
        copy_ms = cs.cuda_ms(lambda: y.copy_(x), 20)
        del x, y

        n, rows, products, degree = cs.sumcheck_cases()["batch_open_2^20"]
        vp = cs.random_vp(n, rows, products, 7, "cuda")
        st = fused.stack_planes(vp)
        half = st.second()
        coeffs = fused.coefficients(vp, "cuda")
        sched = fused.schedule(st.row_vars, products, degree, n, "cuda")
        big = cs.gpt2_opening_shape()
        g = torch.Generator(device="cuda").manual_seed(9)
        rst = fused.empty_stack(big["row_vars"], "cuda")
        for plane in rst.first:
            plane.random_(0, 1 << 62, generator=g)
        rhalf = rst.second()
        rsched = fused.schedule(big["row_vars"], big["factors"], 2, big["num_vars"], "cuda")
        c = torch.randint(0, 1 << 62, (2, len(big["factors"])), generator=g, dtype=torch.int64, device="cuda")
        rcoeffs = gf.GF2(c[0], c[1])
        chals = torch.randint(0, 1 << 62, (2, big["num_vars"]), generator=g, dtype=torch.int64, device="cuda")
        partials = torch.empty(8192 * 2 * (degree + 1), dtype=torch.int64, device="cuda")
        checked = {k: v for k, v in cs.sumcheck_cases().items() if "ragged" in k or k == "batch_open_2^20"}

        order = list(libs) + list(libs)[::-1]
        times = collections.defaultdict(list)
        mismatches = {}
        for name in order:
            use(name)
            if name in ("kernel", "no_prefetch") and name not in mismatches:
                mismatches[name] = cs.check_sumcheck(checked)["mismatches"]
            times[name].append({
                "uniform_round_1_ms": cs.device_ms(lambda: fused.round_cuda(
                    st.first, half, st.meta, st.rows, 0, st.length, chals, 1, n, sched, coeffs, partials, degree),
                    10, "round_kernel"),
                "gpt2_opening_round_1_ms": cs.device_ms(lambda: fused.round_cuda(
                    rst.first, rhalf, rst.meta, rst.rows, 0, rst.length, chals, 1, big["num_vars"], rsched,
                    rcoeffs, partials, 2), 5, "round_kernel"),
                "gpt2_opening_round_0_ms": cs.device_ms(lambda: fused.round_cuda(
                    rst.first, rhalf, rst.meta, rst.rows, 0, rst.length, chals, 0, big["num_vars"], rsched,
                    rcoeffs, partials, 2), 5, "round_kernel"),
            })
        entries = sum(1 << lg for lg in big["row_vars"])
        print(json.dumps({
            "part": "round_kernel_designs", "card": cs.nvidia_smi("name,power.limit"),
            "copy_2gib_ms": copy_ms, "copy_rate_tb_per_s": 2 * (1 << 28) * 8 / copy_ms / 1e9,
            "bound_ms": {"uniform_round_1": st.rows * st.length * 16 * 1.5 / cs.HBM_BYTES_PER_S * 1e3,
                         "gpt2_opening_round_1": (entries + entries // 2) * 16 / cs.HBM_BYTES_PER_S * 1e3,
                         "gpt2_opening_round_0": entries * 16 / cs.HBM_BYTES_PER_S * 1e3},
            "times_in_turns": times, "mismatches": mismatches, "ptxas": ptxas, "sass_degree_2": sass,
            "grid": fused.round_config(degree, sched.items, st.rows),
            "opening_source": big["source"],
        }), flush=True)
        if any(mismatches.values()):
            raise AssertionError(f"a round kernel disagrees with the per-round prover: {mismatches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
