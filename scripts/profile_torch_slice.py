#!/usr/bin/env python3
"""Where one prove of Dense-4M, of the CIFAR-10 LeNet, of GPT-2's
feed-forward path or of GPT-2-124M's generation step spends its time on a
GPU.

    python3 scripts/profile_torch_slice.py [mlp] [cnn] [gpt2_ffn] [gpt2] [kernel]

With no argument mlp, cnn and kernel run. `mlp` builds Dense-4M
(bench.py's build_mlp_4m: six Dense -> Requant -> ReLU blocks, dims
[4, 1024 x5, 3]), `cnn` the LeNet, `gpt2_ffn` GPT-2 at width 128 from
its Positional node through the feed-forward halves of blocks 0 and 1,
and `gpt2` GPT-2-124M's whole graph cut to two blocks (Embeddings to
Logits, the tokens its input), each as chip_smoke.py's phase of that
name builds it; each runs setup and a warm prove, then prints:
  1. `components`: inclusive wall time and calls of the prove's main steps
     (the lookup witnesses and their commits, the consolidated lookup
     proofs, the table proofs, the layer proves, the sumchecks, the
     commitment opening and its parts; for the LeNet also each conv's
     clearing, iFFT, hadamard and FFT sumchecks, its two delegation
     chains, its phi tables, the maxpools, and the FFT rows of inference),
     for GPT-2 also each LayerNorm, MatMul, Gelu, Add and Positional
     prove and the fan-out merges, and for `gpt2` each Embeddings, QKV,
     ConcatMatMul, Permute, Softmax and Logits prove),
     each wrapped (in this script only) with a device synchronize on entry
     and exit, so queued device work is charged to the step that queued it;
  2. `profile`: one prove under torch.profiler (CPU and CUDA activity):
     kernel launches, summed kernel time, the device's busy share of an
     unprofiled warm prove, the kernels that take the most time, the
     Merkle-compression kernel's own time and launches, the launches made
     inside the sumchecks (each sumcheck a named range) and their device
     time, the device time and launches of the sumcheck with the most
     device time and of the batch opening's sumcheck, each split into its
     round, finish and tail kernels and the rest, each hand kernel's
     launches;
     then one more warm prove under
     torch.cuda.set_sync_debug_mode("warn"), counting torch's
     synchronizing calls by the line that made them;
  3. `kernel`: what limits the Merkle-compression kernel. Its SASS opcode
     mix and the length of each loop body (instructions from a backward
     branch's target to the branch), and the rate at which the card issues
     each 32-bit multiply that a Goldilocks product lowers to, measured by
     `scripts/int_mul_rates.cu` (multiplies an SM a clock, the clock read
     inside the kernel), with the multiply bound at 2^19 pairs that the
     measured wide-multiply rate gives beside chip_smoke.py's `bound_ms`.
Prints one JSON line per part (`path` names the model). Needs a CUDA device.
"""

from __future__ import annotations

import bisect
import collections
import inspect
import json
import os
import re
import shutil
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _wrap(owner, name, table, key):
    """Replace owner.name by a synchronizing timer; returns what to restore."""
    raw = inspect.getattr_static(owner, name)
    fn = getattr(owner, name)

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        entry = table[key]
        entry[0] += time.perf_counter() - t0
        entry[1] += 1
        return out

    setattr(owner, name, staticmethod(timed) if isinstance(raw, staticmethod) else timed)
    return raw


# PTX multiply -> its kernel in scripts/int_mul_rates.cu; the op id is the index
RATE_OPS = {
    "mad.wide.u32": "mad_wide_u32_kernel",
    "mad.lo.u32": "mad_lo_u32_kernel",
    "mad.hi.u32": "mad_hi_u32_kernel",
}


def mul_rates(cs, passes: int = 8192, repeats: int = 3) -> dict:
    """PTX multiply -> its measured issue rate and the SASS opcodes its
    kernel lowered to (see scripts/int_mul_rates.cu)."""
    import ctypes

    from deepprove_tpu_torch import native

    src = os.path.join(ROOT, "scripts", "int_mul_rates.cu")
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    so = native.build_shared_lib("int_mul_rates", [src], lambda inc, out: [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-o", out, src,
    ])
    lib = ctypes.CDLL(so)
    lib.dp_rate_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    threads, blocks = 256, 4 * sms  # one wave: 32 warps on every SM
    operands = torch.tensor([0x7E3779B9, 0x45EBCA6B], dtype=torch.int32, device="cuda")
    out = torch.empty(blocks * threads, dtype=torch.int64, device="cuda")
    clocks = torch.zeros(4, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    muls = blocks * threads * passes * lib.dp_rate_muls_per_pass()
    rates = {}
    for op, (name, kernel) in enumerate(RATE_OPS.items()):
        runs = []
        for _ in range(repeats + 1):  # the first run warms up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.dp_rate_launch(op, operands.data_ptr(), out.data_ptr(), clocks.data_ptr(),
                                     blocks, threads, passes, stream)
            end.record()
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"{name} rate kernel launch failed: cudaError {err}")
            c0, t0, c1, t1 = clocks.tolist()
            runs.append((start.elapsed_time(end), (c1 - c0) / (t1 - t0)))
        ms = statistics.median(r[0] for r in runs[1:])
        ghz = statistics.median(r[1] for r in runs[1:])
        sass = collections.Counter(_opcode(text) for _, text in cs.kernel_sass(so, kernel))
        rates[name] = {"ms": ms, "sm_clock_ghz": ghz, "muls_per_s": muls / (ms * 1e-3),
                       "muls_per_sm_per_clock": muls / (ms * 1e-3) / sms / (ghz * 1e9),
                       "sass_opcodes": dict(sass.most_common(4))}
    return rates


def _opcode(instruction: str) -> str:
    return instruction.split()[1 if instruction.startswith("@") else 0]


def kernel_part(cs) -> None:
    """The Merkle kernel's code shape and the multiply rates it runs at."""
    from deepprove_tpu_torch.hashing import poseidon2_cuda

    sass = cs.kernel_sass(poseidon2_cuda.build())
    opcodes = collections.Counter(_opcode(text) for _, text in sass)
    loops = []
    for addr, text in sass:
        target = re.search(r"BRA (0x[0-9a-f]+)", text)
        if target and int(target.group(1), 16) < addr:
            loops.append((addr - int(target.group(1), 16)) // 16 + 1)
    rates = mul_rates(cs)
    # a Goldilocks product is four 32x32 -> 64 wide multiplies
    wides = cs.TIMED_PAIRS * cs.MULS_PER_PAIR * 4
    print(json.dumps({
        "part": "kernel", "kernel": cs.KERNEL, "sass_instructions": len(sass),
        "loop_bodies": loops, "opcodes": dict(opcodes.most_common()), "mul_rates": rates,
        "pairs": cs.TIMED_PAIRS,
        "mul_bound_ms_at_measured_wide_rate": wides / rates["mad.wide.u32"]["muls_per_s"] * 1e3,
        "card": cs.nvidia_smi("name,power.limit"),
    }), flush=True)


class ConvSteps:
    """Names each sumcheck a Convolution.prove runs by its order (clearing,
    ifft, hadamard, fft) and charges the delegation chains and phi tables
    to their conv, by wrapping the conv module's bound names."""

    ORDER = ("clearing", "ifft", "hadamard", "fft")

    def __init__(self, table):
        self.table, self.node, self.seq, self.in_deleg = table, None, 0, False

    def install(self):
        from deepprove_tpu_torch.zkml.layers import convolution as conv

        self.saved = {n: getattr(conv, n) for n in ("prove_device", "delegate_prove", "phi_partials")}
        saved_prove = conv.Convolution.prove
        self.saved_prove = saved_prove
        me = self

        def timed(key, fn, *args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            entry = me.table[key]
            entry[0] += time.perf_counter() - t0
            entry[1] += 1
            return out

        def conv_prove(self_, node_id, *args):
            me.node, me.seq = node_id, 0
            out = timed(f"conv{node_id}", saved_prove, self_, node_id, *args)
            me.node = None
            return out

        def prove_device(vp, dt):
            if me.node is None or me.in_deleg:
                return me.saved["prove_device"](vp, dt)
            name = ConvSteps.ORDER[me.seq]
            me.seq += 1
            return timed(f"conv{me.node}_{name}_sumcheck", me.saved["prove_device"], vp, dt)

        def delegate_prove(*args):
            me.in_deleg = True
            out = timed(f"conv{me.node}_delegation", me.saved["delegate_prove"], *args)
            me.in_deleg = False
            return out

        conv.Convolution.prove = conv_prove
        conv.prove_device = prove_device
        conv.delegate_prove = delegate_prove
        conv.phi_partials = lambda *a: timed(f"conv{me.node}_phi_tables", self.saved["phi_partials"], *a)

    def restore(self):
        from deepprove_tpu_torch.zkml.layers import convolution as conv

        for n, fn in self.saved.items():
            setattr(conv, n, fn)
        conv.Convolution.prove = self.saved_prove


def build_path(cs, path):
    """(model, first input as numpy) of chip_smoke.py's phase for `path`."""
    import numpy as np

    import torch_reference as R
    from deepprove_tpu_torch.zkml.convert import mlp_chain_from_arrays

    if path == "cnn":
        return cs.quantized_lenet(R.LENET, *R.lenet_float_ops(R.LENET, np.random.default_rng(0)))
    if path == "gpt2_ffn":
        return cs.gpt2_ffn_model()[:2]
    if path == "gpt2":
        model, _, _, toks = cs.gpt2_model()
        return model, toks
    layers, x_np = cs.build_chain(cs.MLP_4M_DIMS, 0)
    return mlp_chain_from_arrays(layers, device="cuda"), x_np


RANGES = ("sumcheck", "batch_open_sumcheck")  # the profiler ranges: every sumcheck, the batch opening's


def profile_path(cs, path) -> None:
    from deepprove_tpu_torch import glue
    from deepprove_tpu_torch.lookup import logup
    from deepprove_tpu_torch.pcs import basefold, merkle, ntt
    from deepprove_tpu_torch import sumcheck as sumcheck_pkg  # the batch opening's prove_device
    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.zkml import commit
    from deepprove_tpu_torch.zkml.iop import Context, Prover
    from deepprove_tpu_torch.zkml.iop import prover as iop_prover
    from deepprove_tpu_torch.zkml.layers import (activation, add, concat_matmul, convolution, dense, embeddings,
                                                 layernorm, logits, matmul, pooling, qkv, requant, softmax)
    from deepprove_tpu_torch.zkml.tensor import Tensor

    model, x_np = build_path(cs, path)
    x = Tensor(torch.from_numpy(x_np))
    table = collections.defaultdict(lambda: [0.0, 0])
    fft = _wrap(ntt, "fft_rows", table, "inference_fft_rows")
    trace = model.run([x], "cuda")
    ntt.fft_rows = fft
    ctx = Context.generate(model, device="cuda", **cs.PCS_KW)
    Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace)
    warm_ms, _ = cs.wall_ms(lambda: Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace))

    targets = [
        (iop_prover, "generate_lookup_witnesses", "lookup_witnesses"),
        (iop_prover.Prover, "_prove_shared_logup", "shared_logup"),
        (iop_prover.Prover, "_prove_tables", "table_proofs"),
        (requant.Requant, "prove", "requant_layer"),
        (activation.Relu, "prove", "relu_layer"),
        (dense.Dense, "prove", "dense_layer"),
        (pooling.Maxpool2D, "prove", "maxpool_layer"),
        (layernorm.LayerNorm, "prove", "layernorm_layer"),
        (matmul.MatMul, "prove", "matmul_layer"),
        (activation.Gelu, "prove", "gelu_layer"),
        (add.Add, "prove", "add_layer"),
        (embeddings.Positional, "prove", "positional_layer"),
        (embeddings.Embeddings, "prove", "embeddings_layer"),
        (qkv.QKV, "prove", "qkv_layer"),
        (concat_matmul.ConcatMatMul, "prove", "concat_matmul_layer"),
        (concat_matmul.Permute, "prove", "permute_layer"),
        (softmax.Softmax, "prove", "softmax_layer"),
        (logits.Logits, "prove", "logits_layer"),
        (iop_prover, "same_poly_prove_device", "fanout_merges"),
        (commit.CommitmentProver, "prove", "commit_open"),
        (fused, "prove_device", "sumcheck"),
        (basefold, "commit_many", "basefold_commit"),
        (basefold, "_commit_phase_session", "basefold_commit_phase"),
        (basefold, "_query_openings", "basefold_query_openings"),
        (merkle.MerkleTree, "from_leaves_many", "merkle_tree"),
        (glue, "materialize", "materialize"),
    ]
    originals = [(o, n, _wrap(o, n, table, k)) for o, n, k in targets]
    by_name = (dense, requant, pooling, logup, commit, sumcheck_pkg, matmul, layernorm, embeddings, qkv, concat_matmul,
               softmax, logits)  # bound prove_device by name
    for mod in by_name:
        mod.prove_device = fused.prove_device
    convolution.prove_device = fused.prove_device
    conv_steps = ConvSteps(table)
    conv_steps.install()
    total_ms, _ = cs.wall_ms(lambda: Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace))
    conv_steps.restore()
    for owner, name, raw in originals:
        setattr(owner, name, raw)
    for mod in by_name + (convolution,):
        mod.prove_device = fused.prove_device
    print(json.dumps({
        "part": "components", "path": path, "warm_prove_ms": warm_ms, "synced_prove_ms": total_ms,
        "inclusive_ms": {k: v[0] * 1e3 for k, v in table.items()},
        "calls": {k: v[1] for k, v in table.items()},
        "card": cs.nvidia_smi("name,power.limit"),
    }), flush=True)

    from torch.profiler import ProfilerActivity, profile, record_function

    # one prove under the profiler, each sumcheck in a named range
    plain_prove_device = fused.prove_device

    def ranged(vp, dt, **kw):
        with record_function("sumcheck"):
            return plain_prove_device(vp, dt, **kw)

    def opening_ranged(vp, dt, **kw):  # the batch opening passes its rows laid out (`stacked`)
        with record_function("batch_open_sumcheck"):
            return plain_prove_device(vp, dt, **kw)

    for mod in (fused,) + by_name + (convolution,):
        mod.prove_device = ranged
    sumcheck_pkg.prove_device = opening_ranged  # the one caller that imports it at its call: basefold's opening
    cs.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace)
        torch.cuda.synchronize()
    launches_by_kernel = cs.read_launches()
    for mod in (fused,) + by_name + (convolution,):
        mod.prove_device = plain_prove_device
    # the raw kineto events: building the profiler's FunctionEvent tree for
    # millions of launches takes longer than the prove itself
    per_kernel = collections.defaultdict(lambda: [0.0, 0])
    windows, launch_at, kernel_us_by_corr, kernel_name_by_corr = [], [], {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if e.name() in RANGES:
                continue  # the range's own record on the device timeline, not a kernel
            rec = per_kernel[e.name()[:160]]
            rec[0] += e.duration_ns() / 1e3
            rec[1] += 1
            kernel_us_by_corr[e.correlation_id()] = e.duration_ns() / 1e3
            kernel_name_by_corr[e.correlation_id()] = e.name()
        elif e.name() in RANGES:
            windows.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif "LaunchKernel" in e.name() or "LaunchCooperativeKernel" in e.name():  # the tail is cooperative
            launch_at.append((e.start_ns(), e.correlation_id()))
    windows.sort()
    in_sumcheck = []
    # each sumcheck's device time by kernel: the round, finish and tail
    # kernels, and the rest (the sponge's launch of [n, degree], torch ops)
    split = collections.defaultdict(lambda: collections.defaultdict(lambda: [0.0, 0]))
    for t, corr in launch_at:
        i = bisect.bisect_right(windows, (t, float("inf"))) - 1
        if i >= 0 and windows[i][0] <= t <= windows[i][1]:
            in_sumcheck.append(corr)
            name = kernel_name_by_corr.get(corr, "")
            kind = next((k for k in ("round_kernel", "finish_kernel", "tail_kernel") if k in name), "other")
            split[i][kind][0] += kernel_us_by_corr.get(corr, 0.0) / 1e3
            split[i][kind][1] += 1
    largest = max(split.values(), key=lambda d: sum(v[0] for v in d.values()), default={})
    opening = [split[i] for i, w in enumerate(windows) if w[2] == RANGES[1]]
    kernel_us = sum(v[0] for v in per_kernel.values())
    merkle_k = [v for k, v in per_kernel.items() if cs.KERNEL in k]
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:10]

    # one warm prove with torch's synchronizing calls counted
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in caught
        if "called a synchronizing" in str(w.message)
    )
    print(json.dumps({
        "part": "profile", "path": path, "kernel_launches": sum(v[1] for v in per_kernel.values()),
        "kernel_ms": kernel_us / 1e3, "warm_prove_ms": warm_ms,
        "busy_share": kernel_us / 1e3 / warm_ms,
        "sumcheck_calls": len(windows),
        "sumcheck_launches": len(in_sumcheck),
        "sumcheck_kernel_ms": sum(kernel_us_by_corr.get(c, 0.0) for c in in_sumcheck) / 1e3,
        "sumcheck_inclusive_ms": table["sumcheck"][0] * 1e3,
        "largest_sumcheck_device": {k: {"ms": v[0], "launches": v[1]} for k, v in sorted(largest.items())},
        "batch_open_sumcheck_device": [{k: {"ms": v[0], "launches": v[1]} for k, v in sorted(d.items())}
                                       for d in opening],
        "launches_by_kernel": launches_by_kernel,
        "merkle_kernel_ms": sum(v[0] for v in merkle_k) / 1e3,
        "merkle_kernel_launches": sum(v[1] for v in merkle_k),
        "synchronizing_calls": sum(syncs.values()),
        "synchronizing_calls_by_line": dict(syncs.most_common(12)),
        "top": [{"kernel": k, "ms": v[0] / 1e3, "count": v[1]} for k, v in top],
        "card": cs.nvidia_smi("name,power.limit"),
    }), flush=True)


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    parts = argv or ["mlp", "cnn", "kernel"]
    for part in parts:
        if part == "kernel":
            kernel_part(cs)
        elif part in ("mlp", "cnn", "gpt2_ffn", "gpt2"):
            profile_path(cs, part)
        else:
            raise SystemExit(f"unknown part {part!r}; choose from mlp, cnn, gpt2_ffn, gpt2, kernel")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
