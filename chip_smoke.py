#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`deepprove_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build   - nvcc builds the Poseidon2 Merkle-compression kernel for
               sm_90a from `deepprove_tpu_torch/csrc`, timed; the card's
               name and power limit as nvidia-smi reports them; the
               kernel's SASS length, registers, local (spill) memory,
               block size and resident warps an SM.
  2. kernels - the kernel against its plain torch version (bit-identical)
               on random levels at sizes on both sides of the block and
               warp boundaries and on levels of the edge values
               {0, 1, 2^32 - 1, 2^32, 2^63, p - 2, p - 1}; the library's
               field arithmetic on operands in [p, 2^64) against Python
               ints; the golden Merkle root; kernel / plain times at 2^19
               pairs beside the least time the card could take.
  3. slice   - the Dense-only chain [4, 1024, 1024, 3] at the reference's
               parameters (200 queries, rate 1/2, basecode 2^7):
               Model.run -> Context.generate -> Prover.prove -> verify on
               the card, the verifier rejecting a changed output, and the
               kernel's launches in that run; then the medians of three warm
               setup/prove/verify runs and the transcript's device copies.
  4. mlp_4m  - Dense-4M as bench.py's build_mlp_4m builds it (six Dense ->
               Requant -> ReLU blocks, [4, 1024 x5, 3], logup-GKR for the
               lookups), driven and measured as the slice is; the output
               must equal a numpy evaluation of the same chain.
  5. cnn     - the CIFAR-10 LeNet of PyTorch's "Training a classifier"
               tutorial (3x32x32 input; conv 6@5x5, ReLU, maxpool; conv
               16@5x5, ReLU, maxpool; flatten; dense 120, 84, 10 with ReLU
               between), weights from default_rng(0) in PyTorch's default
               init, `pad_pass` then `quantize(..., "inference", two
               inputs)`, the first input proved as bench.py's bench_cnn
               does, driven and measured as the slice is; the output must
               equal a numpy evaluation of the quantized model.
  6. reference - the Dense chain [16, 32, 8], the Dense -> Requant ->
               ReLU chain [4, 16, 16, 3] and the three small CNNs of the CPU
               tests (conv -> requant -> maxpool -> flatten -> dense, a
               stride-2 conv, a tiny LeNet) proved on the card must equal
               the JAX package's proofs frozen in tests/torch_reference.json.
Then the seconds each phase took, the kernel table line (its `launches`
are those of the cnn phase, the main path) and, last, the device line.
Any failure raises and exits non-zero; without a CUDA device it exits 2
and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))

# H100 SXM device-memory rate (NVIDIA data sheet); the multiply rate is
# computed from the card itself (SM count x clock) in `_int_mul_rate`.
HBM_BYTES_PER_S = 3.35e12
INT32_MULS_PER_SM_PER_CLOCK = 64  # sm_90 32-bit IMAD throughput
# Goldilocks muls per pair: 2 permutations x (8*8*4 + 22*(4 + 8)); each a
# 64x64 -> 128-bit product = four 32x32 -> 64 partial products = 8 32-bit
# multiplies. Bytes per pair: 8 u64 read + 4 u64 written.
MULS_PER_PAIR = 2 * (8 * 8 * 4 + 22 * (4 + 8))
INT32_MULS_PER_MUL = 8
BYTES_PER_PAIR = 12 * 8
WARM_RUNS = 3  # warm setup/prove/verify repeats after the cold run; medians reported
DEVICE = "cuda"  # where the paths run (a test harness may point it elsewhere)
PCS_KW = dict(num_queries=200, basecode_msg_size_log=7)  # the reference's parameters
MLP_4M_DIMS = [4, 1024, 1024, 1024, 1024, 1024, 3]  # bench.py:164 build_mlp_4m
KERNEL = "compress_level_kernel"
TIMED_PAIRS = 1 << 19  # the main path's largest level (the 2^21-leaf weight tree's first)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def _int_mul_rate() -> float:
    """32-bit integer multiplies per second at the card's max SM clock."""
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_MULS_PER_SM_PER_CLOCK * mhz * 1e6


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of fn() in ms over `iters` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def kernel_sass(so: str, kernel: str = KERNEL) -> list[tuple[int, str]]:
    """(address, instruction) of each SASS instruction of `kernel` (by
    default the compression kernel) in library `so`, from `cuobjdump -sass`."""
    sass = subprocess.run(["cuobjdump", "-sass", so], capture_output=True, text=True).stdout
    out, inside = [], False
    for ln in sass.splitlines():
        if "Function :" in ln:
            inside = kernel in ln
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+([^;]*)", ln)
        if inside and m:
            out.append((int(m.group(1), 16), m.group(2)))
    return out


def kernel_resources(so: str) -> dict:
    """Registers, stack and local (spill) bytes of the compression kernel."""
    usage = subprocess.run(["cuobjdump", "-res-usage", so], capture_output=True, text=True).stdout
    lines = usage.splitlines()
    res = next(lines[i + 1] for i, ln in enumerate(lines) if KERNEL in ln)
    regs, stack, local = (int(re.search(rf"{k}:(\d+)", res).group(1)) for k in ("REG", "STACK", "LOCAL"))
    return {"registers": regs, "stack_bytes": stack, "local_bytes": local}


def phase_build():
    from deepprove_tpu_torch import native
    from deepprove_tpu_torch.hashing import poseidon2_cuda

    t0 = time.perf_counter()
    so = poseidon2_cuda.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.get_lib()
    host_build_s = time.perf_counter() - t0
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    threads, blocks_per_sm = poseidon2_cuda.launch_config()
    n = len(kernel_sass(so))
    stats = {
        "sass_instructions": n, "sass_bytes": 16 * n, **kernel_resources(so),
        "threads_per_block": threads, "blocks_per_sm": blocks_per_sm,
        "resident_warps_per_sm": blocks_per_sm * threads // 32,
    }
    emit({
        "phase": "build", "ok": True, "nvcc_s": build_s, "gcc_s": host_build_s,
        "library": os.path.relpath(so, ROOT), "card": card, "kernel": KERNEL, **stats,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return card, stats


def check_levels(threads: int, seed: int = 7) -> dict:
    """Name -> (4, 2M) uint64 level: random ones at sizes on both sides of
    the block (`threads`) and warp boundaries and at TIMED_PAIRS, all-equal
    levels of each edge value, and random mixes of them."""
    from deepprove_tpu_torch.fields import host

    rng = np.random.default_rng(seed)
    edge = np.array(host.EDGE_VALUES, dtype=np.uint64)
    levels = {f"edge_all_{v}": np.full((4, 2 * 33), v, dtype=np.uint64) for v in host.EDGE_VALUES}
    for m in (threads + 1, (1 << 17) + 5):
        levels[f"edge_mix_{m}"] = rng.choice(edge, size=(4, 2 * m))
    for m in sorted({1, 3, 31, 32, 33, threads - 1, threads, threads + 1, 1000, (1 << 17) + 5, TIMED_PAIRS}):
        levels[f"random_{m}"] = rng.integers(0, host.P, size=(4, 2 * m), dtype=np.uint64)
    return levels


def probe_operands(seed: int = 11) -> tuple:
    """Three (N,) uint64 operand vectors, mostly in [p, 2^64): the range that
    lazy reduction lets values reach inside the kernel."""
    from deepprove_tpu_torch.fields import host

    rng = np.random.default_rng(seed)
    top = [host.P, host.P + 1, 2**64 - 2**32, 2**64 - 2, 2**64 - 1]
    pool = np.array(top + list(host.EDGE_VALUES), dtype=np.uint64)
    return tuple(
        np.concatenate([rng.integers(host.P, 2**64 - 1, size=2048, dtype=np.uint64, endpoint=True),
                        rng.choice(pool, size=512)])
        for _ in range(3)
    )


def phase_kernels(threads: int):
    import torch_reference as R

    from deepprove_tpu_torch.fields import gf
    from deepprove_tpu_torch.hashing import poseidon2_cuda as pc
    from deepprove_tpu_torch.pcs.merkle import MerkleTree

    mismatches, max_err, per_level = 0, 0, {}
    levels = check_levels(threads)
    for name, host_level in levels.items():
        level = gf.from_u64(host_level, "cuda")
        got = pc.compress_level_cuda(level)
        want = pc.compress_level_plain(level)
        torch.cuda.synchronize()
        bad = (got != want).any(dim=0)
        n_bad = int(bad.sum())
        if n_bad:
            g, w = gf.to_u64(got[:, bad]), gf.to_u64(want[:, bad])
            max_err = max(max_err, max(abs(int(a) - int(b)) for a, b in zip(g.ravel(), w.ravel())))
        mismatches += n_bad
        per_level[name] = n_bad

    a, b, c = probe_operands()
    got = gf.to_u64(pc.goldilocks_probe(*(gf.from_u64(x, "cuda") for x in (a, b, c))))
    probe_mismatches = int((got != R.goldilocks_probe_plain(a, b, c)).sum())

    with open(os.path.join(ROOT, "tests", "golden_vectors.json")) as f:
        golden = json.load(f)["merkle_root_0to15"]
    root = MerkleTree.from_leaves(gf.from_u64(np.arange(16, dtype=np.uint64), "cuda")).root
    golden_ok = list(root) == golden

    pairs = TIMED_PAIRS
    level = gf.from_u64(levels[f"random_{pairs}"], "cuda")
    kernel_ms = cuda_ms(lambda: pc.compress_level_cuda(level), 20)
    plain_ms = cuda_ms(lambda: pc.compress_level_plain(level), 2)
    rate = _int_mul_rate()
    ops_ms = pairs * MULS_PER_PAIR * INT32_MULS_PER_MUL / rate * 1e3
    bytes_ms = pairs * BYTES_PER_PAIR / HBM_BYTES_PER_S * 1e3
    ok = mismatches == 0 and probe_mismatches == 0 and golden_ok
    result = {
        "phase": "kernels", "ok": ok, "mismatches": mismatches, "per_level": per_level,
        "field_probe_operands": int(a.size), "field_probe_mismatches": probe_mismatches,
        "golden_root_ok": golden_ok, "pairs": pairs, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "int32_mul_rate_per_s": rate, "max_abs_err": max_err,
    }
    emit(result)
    if not ok:
        raise AssertionError("kernel disagrees with its plain version")
    return result


def build_chain(dims, seed):
    """bench.py's Dense-4M draw order: per layer matrix then bias, x last."""
    from deepprove_tpu_torch.zkml import quantization as Q

    rng = np.random.default_rng(seed)
    layers = []
    for i in range(len(dims) - 1):
        w = rng.integers(Q.MIN, Q.MAX + 1, size=(dims[i + 1], dims[i])).astype(np.int64)
        b = rng.integers(Q.MIN, Q.MAX + 1, size=dims[i + 1]).astype(np.int64)
        layers.append((w, b))
    return layers, rng.integers(Q.MIN, Q.MAX + 1, size=dims[0]).astype(np.int64)


def count_field_elements(obj) -> int:
    """Field elements in a materialized proof (an ext element counts 2;
    query indices are not field elements)."""
    import dataclasses

    if dataclasses.is_dataclass(obj):
        return sum(
            count_field_elements(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
            if f.name not in ("query_indices", "variable_gap")
        )
    if isinstance(obj, dict):
        return sum(count_field_elements(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(count_field_elements(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return int(obj.size)
    return 1 if isinstance(obj, int) else 0


def numpy_mlp(layers, x_np, specs):
    """The Dense -> Requant -> ReLU chain evaluated with numpy int64."""
    from deepprove_tpu_torch.zkml import quantization as Q

    v = x_np
    for (w, b), s in zip(layers, specs):
        v = w @ v + b
        v = (v * s.fixed_point_multiplier + (1 << (s.shift - 1))) >> s.shift
        v = np.maximum(np.clip(v, Q.MIN, Q.MAX), 0)
    return v


def drive(name, model, x_np, want, pcs_kw, warm_runs):
    """The main path once (Model.run -> Context.generate -> Prover.prove ->
    verify) with the kernel's launch count set to 0 just before it, the
    verifier rejecting a changed output, then `warm_runs` warm repeats."""
    from deepprove_tpu_torch.fields import gf
    from deepprove_tpu_torch.hashing import poseidon2_cuda as pc
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript
    from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
    from deepprove_tpu_torch.zkml.tensor import Tensor

    x = Tensor(torch.from_numpy(x_np))
    torch.cuda.reset_peak_memory_stats()
    pc.LAUNCHES = 0
    run_ms, trace = wall_ms(lambda: model.run([x], DEVICE))
    got = trace.outputs[0].data.cpu().numpy()
    assert np.array_equal(got[: len(want)], want), "inference differs from numpy"
    cold_setup_ms, ctx = wall_ms(lambda: Context.generate(model, device=DEVICE, **pcs_kw))
    launches_setup = pc.LAUNCHES
    prover = Prover(ctx, BasicTranscript(b"m2vec"), device=DEVICE)
    cold_prove_ms, proof = wall_ms(lambda: prover.prove(trace))
    launches_prove = pc.LAUNCHES - launches_setup
    cold_verify_ms, _ = wall_ms(
        lambda: verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"), device=DEVICE)
    )
    launches = pc.LAUNCHES
    launches_verify = launches - launches_setup - launches_prove
    if launches_prove == 0:
        raise AssertionError("the prove launched the compression kernel no time")

    bad = trace.outputs[0].data.clone()
    bad[0] += 1
    try:
        verify(ctx, proof, IO([x], [Tensor(bad)]), BasicTranscript(b"m2vec"), device=DEVICE)
    except AssertionError:
        pass  # the expected rejection
    else:
        raise AssertionError("verify accepted a changed output")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    warm = {"setup_ms": [], "prove_ms": [], "verify_ms": []}
    for _ in range(warm_runs):
        ms, ctx = wall_ms(lambda: Context.generate(model, device=DEVICE, **pcs_kw))
        warm["setup_ms"].append(ms)
        ms, proof = wall_ms(lambda: Prover(ctx, BasicTranscript(b"m2vec"), device=DEVICE).prove(trace))
        warm["prove_ms"].append(ms)
        ms, _ = wall_ms(
            lambda: verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"), device=DEVICE)
        )
        warm["verify_ms"].append(ms)

    # what holding the sponge on the host costs: per-copy times on an idle
    # card, times the copies one prove made
    dt = DeviceTranscript.from_host(BasicTranscript(b"probe"), DEVICE)
    msg = gf.ext_from_pairs([(1, 2), (3, 4), (5, 6)], DEVICE)
    pull_ms, _ = wall_ms(lambda: [dt.append_exts(msg) for _ in range(200)])
    push_ms, _ = wall_ms(lambda: [dt.read_challenge() for _ in range(200)])
    pull_ms, push_ms = pull_ms / 200, push_ms / 200
    result = {
        "phase": name, "ok": True, **pcs_kw, "inference_ms": run_ms,
        **{k: float(np.median(v)) for k, v in warm.items()},
        "warm_runs": warm, "cold_setup_ms": cold_setup_ms,
        "cold_prove_ms": cold_prove_ms, "cold_verify_ms": cold_verify_ms,
        "proof_field_elements": count_field_elements(proof), "launches": launches,
        "launches_setup": launches_setup, "launches_prove": launches_prove,
        "launches_verify": launches_verify, "tampered_output_rejected": True,
        "transcript_pulls": prover.dt.pulls, "transcript_pushes": prover.dt.pushes,
        "pull_ms": pull_ms, "push_ms": push_ms,
        "transcript_copy_ms": prover.dt.pulls * pull_ms + prover.dt.pushes * push_ms,
        "peak_mem_gib": peak_gib,
    }
    return result


def phase_slice():
    """The Dense-only chain [4, 1024, 1024, 3] (no lookups)."""
    from deepprove_tpu_torch.zkml.convert import dense_chain_from_arrays

    dims = [4, 1024, 1024, 3]
    layers, x_np = build_chain(dims, 0)
    want = x_np
    for w, b in layers:
        want = w @ want + b
    model = dense_chain_from_arrays(layers, DEVICE)
    result = {**drive("slice", model, x_np, want, PCS_KW, WARM_RUNS), "dims": dims}
    emit(result)
    return result


def phase_mlp_4m():
    """Dense-4M exactly as bench.py's build_mlp_4m builds it: six Dense ->
    Requant -> ReLU blocks at width 1024, weights from default_rng(0)."""
    from deepprove_tpu_torch.zkml.convert import mlp_chain_from_arrays

    layers, x_np = build_chain(MLP_4M_DIMS, 0)
    model = mlp_chain_from_arrays(layers, device=DEVICE)
    specs = [model.nodes[i].op.spec for i in range(1, len(model.nodes), 3)]
    result = {
        **drive("mlp_4m", model, x_np, numpy_mlp(layers, x_np, specs), PCS_KW, WARM_RUNS),
        "dims": MLP_4M_DIMS, "clamping_sizes": sorted({s.clamping_size() for s in specs}),
    }
    emit(result)
    return result


def quantized_lenet(cfg, ops, xs):
    """A LeNet float model of tests/torch_reference.py's `lenet_float_ops`,
    through `pad_pass` where its config asks for it and `quantize` with the
    inference observer on all inputs; returns (model, first input quantized)."""
    from deepprove_tpu_torch.zkml.convert import float_model_from_ops
    from deepprove_tpu_torch.zkml.float_model import quantize
    from deepprove_tpu_torch.zkml.padding import pad_pass

    fm = float_model_from_ops(cfg["input_shape"], ops)
    if cfg["pad_pass"]:
        pad_pass(fm)
    model, s_in, _ = quantize(fm, "inference", xs, device=DEVICE)
    return model, s_in.quantize(xs[0])


def phase_cnn():
    """The CIFAR-10 LeNet at full width, quantized from a float model:
    weights then bias a layer from default_rng(0), uniform(+-1/sqrt(fan_in)),
    then two inputs from uniform(-1, 1); the first is proved."""
    import torch_reference as R

    model, x_np = quantized_lenet(R.LENET, *R.lenet_float_ops(R.LENET, np.random.default_rng(0)))
    want = R.numpy_eval(R.layer_records(model), x_np)
    specs = [model.nodes[n].op.spec for n in model.forward_order() if hasattr(model.nodes[n].op, "spec")]
    result = {
        **drive("cnn", model, x_np, want, PCS_KW, WARM_RUNS), "lenet": R.LENET,
        "clamping_sizes": sorted({s.clamping_size() for s in specs}),
        "layers": [type(model.nodes[n].op).__name__ for n in model.forward_order()],
    }
    emit(result)
    return result


def small_cnn(name):
    """One of the CPU tests' CNN cases as (model on the card, input)."""
    import torch_reference as R

    from deepprove_tpu_torch.zkml.convert import model_from_layers

    if name == "lenet":
        return quantized_lenet(R.LENET_TINY, *R.cnn_case(name))
    layers, x_np = R.cnn_case(name)
    return model_from_layers(layers, DEVICE), x_np


def phase_reference():
    """The Dense chain, the Dense -> Requant -> ReLU chain and the small
    CNNs of the CPU tests, proved on the card: each proof must equal the
    JAX package's."""
    import torch_reference as R

    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.zkml.convert import dense_chain_from_arrays, mlp_chain_from_arrays
    from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
    from deepprove_tpu_torch.zkml.tensor import Tensor

    ref = R.load()
    all_parts = ("steps", "table_proofs", "shared_logup", "commit")
    dense_layers, dense_x = R.dense_inputs()
    mlp_layers, mlp_x = R.mlp_inputs()
    cases = {
        "dense": (lambda: (dense_chain_from_arrays(dense_layers, DEVICE), dense_x), R.DENSE_KW,
                  ("steps", "commit"), ref["dense"]),
        "mlp": (lambda: (mlp_chain_from_arrays(mlp_layers, ref["mlp"]["specs"], DEVICE), mlp_x), R.MLP_KW,
                all_parts, ref["mlp"]),
    }
    for name in R.CNN_CASES:
        cases[f"cnn_{name}"] = (lambda name=name: small_cnn(name), R.CNN_KW, all_parts, ref["cnn"][name])
    equal = {}
    for name, (inputs, kw, parts, frozen) in cases.items():
        model, x_np = inputs()
        x = Tensor(torch.from_numpy(x_np))
        trace = model.run([x], DEVICE)
        ctx = Context.generate(model, device=DEVICE, **kw)
        proof = Prover(ctx, BasicTranscript(b"m2vec"), device=DEVICE).prove(trace)
        verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"), device=DEVICE)
        equal[name] = {p: R.plain(getattr(proof, p)) for p in parts} == frozen["proof"]
    ok = all(equal.values())
    emit({"phase": "reference", "ok": ok, "dims": {"dense": R.DENSE_DIMS, "mlp": R.MLP_DIMS},
          "equal_to_jax_proof": equal})
    if not ok:
        raise AssertionError(f"the card's proofs differ from the JAX package's: {equal}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card, stats = phase_build()
    k = phase_kernels(stats["threads_per_block"])
    seconds = {"build_and_kernels": time.perf_counter() - t0}
    paths = []
    for name, phase in (("slice", phase_slice), ("mlp_4m", phase_mlp_4m), ("cnn", phase_cnn)):
        t1 = time.perf_counter()
        paths.append(phase())
        seconds[name] = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_reference()
    seconds["reference"] = time.perf_counter() - t1
    emit({"phase": "elapsed", "seconds": seconds, "total_s": time.perf_counter() - t0})
    cnn = paths[-1]  # the main path: the kernels line's `launches` are its
    emit({"kernels": [{
        "name": "poseidon2_compress_level",
        "route": "cuda",
        "source": "deepprove_tpu_torch/csrc/poseidon2_compress.cu",
        "replaces": "deepprove_tpu/hashing/poseidon2_pallas.py:142",
        "launches": cnn["launches"],
        "launches_by_path": {p["phase"]: [p["launches_setup"], p["launches_prove"], p["launches_verify"]]
                             for p in paths},
        "max_abs_err": k["max_abs_err"],
        "ms": k["kernel_ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": "operations" if k["bound_ops_ms"] >= k["bound_bytes_ms"] else "bytes",
        "library_ms": None,
        "sass_instructions": stats["sass_instructions"],
        "resident_warps_per_sm": stats["resident_warps_per_sm"],
    }]})
    print(card, flush=True)
    emit({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    })
    return 0


if __name__ == "__main__":
    sys.exit(main())
