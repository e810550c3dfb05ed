#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`deepprove_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build   - one nvcc call builds the kernel library for sm_90a from
               `deepprove_tpu_torch/csrc/kernels.cu` (every source in one
               translation unit), timed; the card's name and power limit as
               nvidia-smi reports them; the Merkle kernel's SASS length,
               registers, local (spill) memory, block size and resident
               warps an SM; the registers, stack and local bytes of the
               three kernels that run the duplex (sponge, finish, tail:
               the state must stay in registers, 0 stack and 0 local
               bytes) and of the round kernel; the tail's cooperative grid
               (blocks, threads, blocks an SM) and the round kernel's grid
               at each degree.
  2. kernels - the Merkle kernel against its plain torch version
               (bit-identical) on random levels at sizes on both sides of
               the block and warp boundaries and on levels of the edge
               values {0, 1, 2^32 - 1, 2^32, 2^63, p - 2, p - 1}; the
               library's field arithmetic on operands in [p, 2^64) against
               Python ints; the golden Merkle root; kernel / plain times at
               2^19 pairs beside the least time the card could take. The
               sponge kernel against the host challenger on random session
               scripts (odd-length absorbs, squeezes of 1..33 challenges
               that straddle refills, labels longer than the rate) and
               against the plain torch permutation on single states. The
               sumcheck round + finish kernels and the tail kernel against
               their plain version, the per-round prover, at the main
               path's shapes (logup levels of the LeNet's widest column
               and of Dense-4M's 39 instances, Dense-4M's batch opening,
               maxpool zerochecks of degree 5 with and without a folding
               round above the tail), then the kernels' edge shapes
               (tests/torch_reference.py SUMCHECK_EDGE_CASES: one row, 600
               products, degrees 1-5, a tail from round 0, one variable,
               37 rows, a tail of one round), and the transformer's shapes:
               LayerNorm's io sumcheck (degree 4) and its linking
               sumcheck, whose products list one MLE twice (eq x x), at
               GPT-2's 2^16 entries and at 2^12 with rounds above the tail,
               MatMul's degree-2 sumcheck at 2^12 (the down projection's
               contracted axis), QKV's three products at 2^10,
               ConcatMatMul's degree-3 product at 2^10, Softmax's mask
               sumcheck at 2^16; then rows of their own lengths
               (SUMCHECK_RAGGED_CASES: rows of 2^11, 2 and 1 beside full
               ones above a tail, three sizes and a constant row, the
               batch opening's shape at eight sizes, a row shared by
               products of two spans beside a row that no product lists).
  3. slice   - the Dense-only chain [4, 1024, 1024, 3] at the reference's
               parameters (200 queries, rate 1/2, basecode 2^7):
               Model.run -> Context.generate -> Prover.prove -> verify on
               the card, the verifier rejecting a changed output, and every
               kernel's launches in setup, prove and verify; the sumcheck
               kernels against the per-round prover at the path's stacked
               sumcheck with the most rows (random rows); then the
               medians of three warm setup/prove/verify runs and each warm
               prove's transcript reads (the host reads the state only for
               the Basefold query indices and the final materialize).
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
  6. gpt2_ffn - GPT-2 (vocab 50257, context 1024, 12 blocks calibrated,
               head width 64; synthetic weights from seed 0; seq 64, a
               32-token prompt from default_rng(0), as bench.py's
               bench_gpt2) at width 128 (2 heads) from the graph's
               Positional node through the feed-forward halves of blocks 0
               and 1 (LayerNorm, MatMul 128 -> 512 -> 128 with biases, GELU,
               the residual Adds whose wires fan out), scales from the float
               calibration; the model input is the Embeddings node's output,
               computed on the host. Driven and measured as the slice is;
               the output must equal a numpy evaluation of the same
               quantized graph. One warm run. Phase gpt2 runs the width
               768 this phase was cut from.
  7. gpt2    - one generation step of GPT-2-124M (vocab 50257, width
               768, 12 heads of 64, context 1024; synthetic weights from
               seed 0; seq 64, bench.py's 32-token prompt), its whole
               graph from the Embeddings node (the tokens its input)
               through each block's attention and feed-forward halves to
               the final LayerNorm, the lm_head and Logits, cut to two of
               the 12 blocks (from block 2 on the LayerNorm Requants need
               clamping tables of 2^29 and 2^30 rows, which one card
               cannot commit and prove; two blocks' largest is 2^28):
               Context.generate, Driver.step(prompt, prove=True) cold and
               warm, verify, the verifier rejecting a changed output; the
               output against a numpy evaluation of the same quantized
               graph and the token against its argmax; each step's peak
               memory beside the prediction (GPT2_PEAK_PREDICTION_GIB);
               the tables, the proof's field elements, every kernel's
               launches and the path's largest stacked sumcheck against
               the per-round prover.
  8. reference - the Dense chain [16, 32, 8], the Dense -> Requant ->
               ReLU chain [4, 16, 16, 3], the three small CNNs of the CPU
               tests (conv -> requant -> maxpool -> flatten -> dense, a
               stride-2 conv, a tiny LeNet), the five residual cases (a
               fanned-out residual, an add of two branches, Pad2D alone and
               before a conv, a quantized residual float DAG), the five
               transformer cases (a matmul of two witnesses, embeddings ->
               positional, dense -> requant -> gelu, LayerNorm,
               ffn_fanouts) and the six frozen attention cases (QKV,
               ConcatMatMul plain and transpose_b, Permute, Softmax,
               Logits) proved on the card must equal the JAX
               package's proofs frozen in tests/torch_reference.json, the
               fan-out merges included.
  9. kernel_times - the sponge and sumcheck kernels' device times (from the
               profiler's records, after the paths: the profiler's
               instrumentation slows the rest of a process), their plain
               versions' times and their bounds: bytes for the round
               kernel, which is also timed at GPT-2-124M's batch opening
               (its first folding round at the rows phase gpt2 recorded,
               random values, and the finish on its partials), the
               dependent-product latency (measured by a chain
               of a permutation's products in their order, beside a chain
               of Goldilocks multiplies) for the sponge and finish kernels (the
               finish timed at degree 2 and, on as many partials, at the
               maxpool zerocheck's degree 5), the larger of the two for
               the tail (timed at the batch opening's last 10 rounds, and
               at fused.TAIL_LOG rounds too when that differs).
Then the seconds each phase took, the kernel table line (five kernels;
their `launches` are those of the cnn phase, the main path) and, last,
the device line.
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
TIMED_TAIL_ROUNDS = 10  # the tail row's shape: the batch opening's last 10 rounds, rows of 2^11


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


def device_ms(fn, iters: int, kernel: str) -> float:
    """Mean device time in ms of the launches of `kernel` (a part of its
    name) that `iters` calls of fn make, from the profiler's kernel records,
    after one warm-up: an event-timed loop of launches that last a few
    microseconds measures the host's launch rate instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then delivers no kernel records: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        durs = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                if e.device_type() == torch.autograd.DeviceType.CUDA and kernel in e.name()]
        if durs:
            return sum(durs) / len(durs) / 1e6
    raise AssertionError(f"the profiler recorded no {kernel} launch in 3 sessions")


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


SPONGE_KERNELS = ("sponge_kernel", "finish_kernel", "tail_kernel")  # the kernels that run the duplex


def kernel_resources(so: str, kernel: str = KERNEL) -> dict:
    """Registers, stack and local (spill) bytes of `kernel` (by default the
    compression kernel), the largest over its instances (one a degree for
    the sumcheck kernels), from `cuobjdump -res-usage`."""
    usage = subprocess.run(["cuobjdump", "-res-usage", so], capture_output=True, text=True).stdout
    lines = usage.splitlines()
    found = [lines[i + 1] for i, ln in enumerate(lines) if "Function" in ln and kernel in ln]
    if not found:
        raise AssertionError(f"cuobjdump lists no {kernel}")
    regs, stack, local = (max(int(re.search(rf"{k}:(\d+)", res).group(1)) for res in found)
                          for k in ("REG", "STACK", "LOCAL"))
    return {"registers": regs, "stack_bytes": stack, "local_bytes": local, "instances": len(found)}


def phase_build():
    from deepprove_tpu_torch import kernels, native
    from deepprove_tpu_torch.hashing import poseidon2_cuda
    from deepprove_tpu_torch.sumcheck import fused

    t0 = time.perf_counter()
    so = kernels.build()
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
    # the duplex's state must stay in registers in every kernel that runs it
    sponge_res = {k: kernel_resources(so, k) for k in SPONGE_KERNELS}
    tail = {d: fused.tail_config(d) for d in range(1, fused.MAX_DEGREE + 1)}
    # the round kernel's grid at the batch opening of Dense-4M's shape (63 products, 126 rows)
    round_grid = {d: fused.round_config(d, 63, 126) for d in range(1, fused.MAX_DEGREE + 1)}
    round_res = kernel_resources(so, "round_kernel")
    emit({
        "phase": "build", "ok": True, "nvcc_s": build_s, "gcc_s": host_build_s,
        "library": os.path.relpath(so, ROOT),
        "card": card, "kernel": KERNEL, **stats, "sponge_kernels": sponge_res,
        "sponge_state_in_registers": all(r["stack_bytes"] == 0 and r["local_bytes"] == 0
                                         for r in sponge_res.values()),
        "tail_grid_by_degree": tail, "round_kernel": round_res, "round_grid_by_degree": round_grid,
        "torch": torch.__version__, "cuda": torch.version.cuda,
    })
    return card, {**stats, "sponge_kernels": sponge_res, "tail_grid": tail, "round_kernel": round_res}


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
    sponge = check_sponge()
    sumcheck = check_sumcheck()
    torch.cuda.empty_cache()  # hand the checks' gigabytes back before the paths run
    ok = (mismatches == 0 and probe_mismatches == 0 and golden_ok and sponge["sponge_mismatches"] == 0
          and sponge["permutation_mismatches"] == 0 and sumcheck["mismatches"] == 0)
    result = {
        "phase": "kernels", "ok": ok, "mismatches": mismatches, "per_level": per_level,
        "field_probe_operands": int(a.size), "field_probe_mismatches": probe_mismatches,
        "golden_root_ok": golden_ok, "pairs": pairs, "kernel_ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "int32_mul_rate_per_s": rate, "max_abs_err": max_err,
        "sponge": sponge, "sumcheck": sumcheck,
    }
    emit(result)
    if not ok:
        raise AssertionError("a kernel disagrees with its plain version or the host challenger")
    return result


SPONGE_KS = (1, 2, 3, 5, 7, 16, 33)  # squeezes that straddle refills at odd k
LONG_LABEL = b"a label longer than the rate of the sponge"  # 6 chunks


def check_sponge(seed: int = 5, scripts: int = 8, ops: int = 40) -> dict:
    """The sponge kernel against the host challenger on random session
    scripts (constants, base and extension arrays of odd lengths, some
    longer than the kernel's 32-word batches, squeezes of SPONGE_KS
    challenges with and without labels, label triples), then
    the permutation on single states against the plain torch one."""
    from deepprove_tpu_torch.fields import gf, host
    from deepprove_tpu_torch.hashing import poseidon2
    from deepprove_tpu_torch.transcript import BasicTranscript, DuplexChallenger
    from deepprove_tpu_torch.transcript import device as devt
    from deepprove_tpu_torch.transcript.session import DeviceTranscript, label_chunks

    rng = np.random.default_rng(seed)
    P = host.P
    challenges = mismatches = max_err = long_arrays = 0
    for sc in range(scripts):
        ht = BasicTranscript(b"m2vec")
        ht.append_message(b"script %d" % sc)
        dt = DeviceTranscript.from_host(ht, "cuda")
        for _ in range(ops):
            kind = int(rng.integers(0, 7))
            got = want = None
            if kind == 0:
                vals = rng.integers(0, P, size=int(rng.integers(1, 8)), dtype=np.uint64)
                dt.append_constants(vals.tolist())
                ht.append_field_elements(vals)
            elif kind == 1:
                vals = rng.integers(0, P, size=int(rng.integers(1, 14)), dtype=np.uint64)
                dt.append_base(gf.from_u64(vals, "cuda"))
                ht.append_field_elements(vals)
            elif kind == 2:
                pairs = [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
                         for _ in range(int(rng.integers(1, 10)))]
                dt.append_exts(gf.ext_from_pairs(pairs, "cuda"))
                ht.append_field_element_exts(pairs)
            elif kind == 3:
                k = int(rng.choice(SPONGE_KS))
                got = gf.ext_to_pairs(dt.read_challenges(k))
                want = [ht.read_challenge() for _ in range(k)]
            elif kind == 4:
                k = int(rng.choice(SPONGE_KS))
                label = LONG_LABEL if rng.integers(0, 2) else b"query indices"
                got = gf.ext_to_pairs(dt.get_and_append_challenges(label, k))
                want = [ht.get_and_append_challenge(label) for _ in range(k)]
            elif kind == 5:
                labels = (b"logup_batching", b"logup_alpha", b"logup_lambda")
                got = gf.ext_to_pairs(dt.step(labels=tuple(label_chunks(lbl) for lbl in labels), k=len(labels)))
                want = [ht.get_and_append_challenge(lbl) for lbl in labels]
            elif rng.integers(0, 2):  # past the kernel's 32-word batches of the array
                long_arrays += 1
                vals = rng.integers(0, P, size=int(rng.integers(32, 100)), dtype=np.uint64)
                dt.append_base(gf.from_u64(vals, "cuda"))
                ht.append_field_elements(vals)
            else:
                long_arrays += 1
                pairs = [tuple(int(v) for v in rng.integers(0, P, size=2, dtype=np.uint64))
                         for _ in range(int(rng.integers(16, 50)))]
                dt.append_exts(gf.ext_from_pairs(pairs, "cuda"))
                ht.append_field_element_exts(pairs)
            if want is not None:
                challenges += len(want)
                mismatches += sum(g != w for g, w in zip(got, want))
                max_err = max([max_err] + [abs(a - b) for g, w in zip(got, want) for a, b in zip(g, w)])
        ch = DuplexChallenger()
        devt.import_state(ch, dt.state)
        hc = ht.challenger
        mismatches += int(not (np.array_equal(ch.state, hc.state) and ch.input_buffer == hc.input_buffer
                               and ch.output_buffer == hc.output_buffer))
    # one permutation: a fresh state (nothing queued, no output) duplexes
    # without input on its first squeeze
    states = [rng.integers(0, P, size=8, dtype=np.uint64) for _ in range(6)]
    states += [np.full(8, v, dtype=np.uint64) for v in host.EDGE_VALUES]
    perm_mismatches = 0
    for lanes in states:
        st = torch.zeros(devt.STATE_WORDS, dtype=torch.int64, device="cuda")
        st[:8] = gf.from_u64(lanes, "cuda")
        want = torch.stack(poseidon2.permute_planes([gf.from_u64([int(v)], "cuda") for v in lanes])).reshape(-1)
        devt.sponge_cuda(st, k=1)
        perm_mismatches += int((st[:8] != want).sum())
        g, w = gf.to_u64(st[:8]).tolist(), gf.to_u64(want).tolist()
        max_err = max([max_err] + [abs(a - b) for a, b in zip(g, w)])
    return {"sponge_challenges": challenges, "sponge_mismatches": mismatches, "arrays_past_32_words": long_arrays,
            "permutation_states": len(states), "permutation_mismatches": perm_mismatches,
            "max_abs_err": max_err}


def sponge_permutations(absorbs: int, samples: int) -> int:
    """Permutations of one sponge call that absorbs `absorbs` words and then
    samples `samples`, from a state with no pending input (as every round's
    call starts: the squeeze before it emptied the input buffer). An absorb
    that fills the rate duplexes; a sample duplexes when input is pending or
    the output buffer is empty, else pops."""
    perms, ilen, olen = 0, 0, 0
    for _ in range(absorbs):
        ilen, olen = ilen + 1, 0
        if ilen == 4:
            perms, ilen, olen = perms + 1, 0, 4
    for _ in range(samples):
        if ilen or not olen:
            perms, ilen, olen = perms + 1, 0, 4
        olen -= 1
    return perms


def time_sponge(chain_ns: float) -> dict:
    """One sumcheck round's sponge call (absorb a degree-3 message, the round
    label, squeeze one challenge) on a fresh state: the kernel, the plain
    version (the native host permutation), and the bound: its permutations
    (`sponge_permutations`: 3) of 112 dependent products at the card's
    latency of a permutation's products (`product_latencies`)."""
    from deepprove_tpu_torch.fields import gf
    from deepprove_tpu_torch.sumcheck.prover import ROUND_CHUNKS
    from deepprove_tpu_torch.transcript import device as devt

    msg = gf.ext_from_pairs([(i + 1, i + 2) for i in range(4)], "cuda")
    st = torch.zeros(devt.STATE_WORDS, dtype=torch.int64, device="cuda")
    kernel_ms = device_ms(lambda: devt.sponge_cuda(st.zero_(), arr=msg, labels=(ROUND_CHUNKS,), k=1), 200,
                          "sponge_kernel")
    st_cpu = torch.zeros(devt.STATE_WORDS, dtype=torch.int64)
    msg_cpu = gf.GF2(msg.a0.cpu(), msg.a1.cpu())
    t0 = time.perf_counter()
    for _ in range(200):
        devt.sponge_plain(st_cpu.zero_(), arr=msg_cpu, labels=(ROUND_CHUNKS,), k=1)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 200
    perms = sponge_permutations(2 * msg.shape[0] + len(ROUND_CHUNKS), 2)
    return {"kernel_ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": perms * 112 * chain_ns * 1e-6,
            "permutations": perms}


def product_latencies(iters: int = 112 * 9362) -> dict:
    """The card's latency of one dependent product, in ns, by two chains in
    one thread (`devt.mul_chain`): `mul_latency_ns` of Goldilocks
    multiplies, and `chain_product_ns` of a permutation's 112 products in
    their order (squares, multiplies, multiply-adds), the unit of the
    sponge-running kernels' bounds. Each chain's value is held against
    Python ints first."""
    from deepprove_tpu_torch.fields import host
    from deepprove_tpu_torch.transcript import device as devt

    p = host.P
    out = {}
    for order, key in ((0, "mul_latency_ns"), (1, "chain_product_ns")):
        x = torch.tensor([3, 5], dtype=torch.int64, device="cuda")
        devt.mul_chain(x, 224, order)
        want = 3 * pow(5, 224, p) % p
        if order == 1:
            want = 3
            for _ in range(2):
                for r in range(30):
                    want = want * want * 25 % p
                    if 4 <= r < 26:
                        want = (want * 5 + 5) % p
        if int(x[0]) % (1 << 64) != want:
            raise AssertionError(f"the product chain of order {order} disagrees with Python ints")
        out[key] = cuda_ms(lambda: devt.mul_chain(x, iters, order), 3) * 1e6 / iters
    return out


def sumcheck_cases() -> dict:
    """Main-path sumcheck shapes: name -> (num_vars, rows, products, degree),
    then the kernels' edge shapes (tests/torch_reference.py
    SUMCHECK_EDGE_CASES, each with its tail start or None).
    A logup level of the LeNet's widest (2^13-entry) lookup column: its top
    level, a lookup's input layer over 8 instances (eq, then d_hi, d_lo an
    instance; two products of degree 2 padded with ones); a generic logup
    level of 39 instances, Dense-4M's widest (eq, then n_lo, d_hi, n_hi,
    d_lo an instance: 157 rows, 117 products), at 12 variables with the
    tail from 10, so that two rounds run above it; the batch opening of
    Dense-4M: 63 claims at 2^20 entries, eq and poly rows a claim; the
    maxpool zerocheck (degree 5) of the LeNet's first pool, and the same at
    12 variables with the tail from 10, whose second round folds above it;
    LayerNorm's io (degree 4) and linking (a factor listed twice) sumchecks
    at GPT-2's 64 x 1024 = 2^16 entries and at 2^12 with the tail from 10;
    MatMul's at 2^12; the attention half's: QKV's three-product sumcheck
    at GPT-2's contracted 2^10, ConcatMatMul's degree-3 one over (k, h) at
    2^10, Softmax's mask sumcheck (degree 3) at 2^16. Then the kernels'
    edge shapes and the rows of their own lengths
    (SUMCHECK_RAGGED_CASES). Each path's stacked sumcheck with the most
    entries is checked besides, at the shape the path gave it (`drive`)."""
    import torch_reference as R

    inst = 8
    logup = [p for i in range(inst) for p in ([0, 1 + 2 * i], [0, 2 + 2 * i], [0, 2 + 2 * i, 1 + 2 * i])]
    wide = 39
    generic = [p for r in range(1, 4 * wide, 4) for p in ([0, r, r + 1], [0, r + 2, r + 3], [0, r + 3, r + 1])]
    maxpool = [[0, 1, 2, 3, 4]] + [[k, 4] for k in range(4)] + [[5, 6]]
    # LayerNorm (zkml/layers/layernorm.py): the io sumcheck's rows [eq,
    # gamma, X, V, S, beta], the linking sumcheck's [eq, X, S] with X and S
    # each twice in a product
    ln_io = [[0, 1, 2, 3], [0, 1, 4, 3], [0, 5]]
    ln_link = [[0, 1, 1], [0, 2, 2]]
    return {
        "logup_level_2^13": (12, 1 + 2 * inst, logup, 3),
        "logup_level_39_instances": (12, 1 + 4 * wide, generic, 3, 10),
        "batch_open_2^20": (20, 126, [[2 * c, 2 * c + 1] for c in range(63)], 2),
        "maxpool_zerocheck": (11, 7, maxpool, 5),
        "maxpool_zerocheck_2^12": (12, 7, maxpool, 5, 10),
        "layernorm_io_2^16": (16, 6, ln_io, 4),
        "layernorm_link_2^16": (16, 3, ln_link, 3),
        "layernorm_io_2^12": (12, 6, ln_io, 4, 10),
        "layernorm_link_2^12": (12, 3, ln_link, 3, 10),
        "matmul_2^12": (12, 2, [[0, 1]], 2),
        "qkv_2^10": (10, 6, [[0, 1], [2, 3], [4, 5]], 2),
        "concat_matmul_2^10": (10, 3, [[0, 1, 2]], 3),
        "softmax_mask_2^16": (16, 4, [[0, 1, 2], [0, 1, 3]], 3),
        **R.SUMCHECK_EDGE_CASES,
        **R.SUMCHECK_RAGGED_CASES,
    }


def random_vp(n, rows, products, seed, device, row_vars=None):
    """A VirtualPolynomial with random extension rows (of 2^n entries, or of
    2^row_vars[i] each) and random device coefficients."""
    from deepprove_tpu_torch.fields import gf, host
    from deepprove_tpu_torch.sumcheck import VirtualPolynomial

    rng = np.random.default_rng(seed)
    vp = VirtualPolynomial.new(n)
    if row_vars is None:
        a0 = rng.integers(0, host.P, size=(rows, 1 << n), dtype=np.uint64)
        a1 = rng.integers(0, host.P, size=(rows, 1 << n), dtype=np.uint64)
        vp.add_mle_rows(gf.GF2(gf.from_u64(a0, device), gf.from_u64(a1, device)))
    elif sum(1 << lg for lg in row_vars) <= 1 << 24:
        for lg in row_vars:
            a = rng.integers(0, host.P, size=(2, 1 << lg), dtype=np.uint64)
            vp.add_mle(gf.GF2(gf.from_u64(a[0], device), gf.from_u64(a[1], device)))
    else:  # drawn on the device: GiB of rows would take the host longer than the check
        g = torch.Generator(device=device).manual_seed(seed)
        for lg in row_vars:
            a = torch.randint(0, 1 << 62, (2, 1 << lg), generator=g, dtype=torch.int64, device=device)
            vp.add_mle(gf.GF2(a[0], a[1]))
    for f in products:
        vp.add_product(None, f)
    c = rng.integers(0, host.P, size=(2, len(products)), dtype=np.uint64)
    vp.coeffs_dev = gf.GF2(gf.from_u64(c[0], device), gf.from_u64(c[1], device))
    return vp


def check_sumcheck(cases=None) -> dict:
    """The round + finish kernels and the tail kernel against their plain
    version, the per-round prover (the same rounds in torch on the card,
    the sponge on a CPU state), at the main path's shapes (`cases`, by
    default `sumcheck_cases()`): messages, challenges, final evaluations
    and the sponge state, bit for bit. A case's fifth entry, when given and
    not None, is the tail start (fused.TAIL_LOG) it runs at."""
    from deepprove_tpu_torch.sumcheck import fused, prover
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    per_case, mismatches, max_err = {}, 0, 0
    default_tail = fused.TAIL_LOG
    for i, (name, (n, rows, products, degree, *tail)) in enumerate((cases or sumcheck_cases()).items()):
        row_vars = tail[1] if len(tail) > 1 else None
        vp = random_vp(n, rows, products, 100 + i, "cuda", row_vars)
        ht = BasicTranscript(b"sumcheck %d" % i)
        dt = DeviceTranscript.from_host(ht, "cuda")
        dt_plain = DeviceTranscript.from_host(ht, "cpu")
        tail_log = tail[0] if tail and tail[0] is not None else default_tail
        fused.TAIL_LOG = tail_log
        try:
            out = fused.prove_device(vp, dt)
        finally:
            fused.TAIL_LOG = default_tail
        plain = prover.prove_device(vp, dt_plain)
        msgs, chals, finals = plain.proof.round_messages, plain.proof.point, plain.final_evals
        pairs = [(out.proof.round_messages, msgs), (out.proof.point, chals), (out.final_evals, finals)]
        bad = 0
        for got, want in pairs:
            for g, w in ((got.a0, want.a0), (got.a1, want.a1)):
                diff = g.cpu() != w.cpu()
                bad += int(diff.sum())
                if diff.any():
                    max_err = max(max_err, int((g.cpu()[diff] - w.cpu()[diff]).abs().max()))
        bad += int((dt.state.cpu() != dt_plain.state).sum())
        per_case[name] = {"num_vars": n, "rows": rows, "products": len(products), "degree": degree,
                          "tail_log": tail_log, "mismatches": bad}
        if row_vars is not None:
            per_case[name]["row_vars"] = sorted(set(row_vars))
        mismatches += bad
        del vp, out, plain, msgs, chals, finals
    return {"cases": per_case, "mismatches": mismatches, "max_abs_err": max_err}


def time_sumcheck(chain_ns: float) -> dict:
    """Each sumcheck kernel's device time at the batch opening's shape (the
    round kernel's second round, which folds), its plain version's, and its
    bound; the finish also at degree 5 on as many partials and at degree 2
    on 1024. The tail is timed at TIMED_TAIL_ROUNDS rounds (the shape the
    kernel table has kept since the tail's first port) and, when the
    default tail start differs, at fused.TAIL_LOG rounds too. The round
    kernel and the finish also at GPT-2-124M's batch opening
    (`time_round_ragged`)."""
    from deepprove_tpu_torch.fields import gf
    from deepprove_tpu_torch.sumcheck import VirtualPolynomial, fused, prover
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    n, rows, products, degree = sumcheck_cases()["batch_open_2^20"]
    vp = random_vp(n, rows, products, 7, "cuda")
    dt = DeviceTranscript.from_host(BasicTranscript(b"timing"), "cuda")
    st = fused.stack_planes(vp)
    (s0, s1), half = st.first, st.second()
    m, length = st.rows, st.length
    fidx, coeffs = fused.factor_index(vp, degree, "cuda"), fused.coefficients(vp, "cuda")
    chals = torch.randint(0, 1 << 62, (2, n), dtype=torch.int64, device="cuda")  # canonical
    msgs = torch.empty((2, n, degree + 1), dtype=torch.int64, device="cuda")
    sched = fused.schedule(st.row_vars, products, degree, n, "cuda")
    grid = fused.round_config(degree, sched.items, m)
    partials = torch.empty(grid["blocks"] * 2 * (degree + 1), dtype=torch.int64, device="cuda")
    round_ms = device_ms(lambda: fused.round_cuda((s0, s1), half, st.meta, m, 0, length, chals, 1, n,
                                                  sched, coeffs, partials, degree), 10, "round_kernel")
    blocks = fused.round_cuda((s0, s1), half, st.meta, m, 0, length, chals, 1, n, sched, coeffs,
                              partials, degree)
    s0, s1 = s0.reshape(m, length), s1.reshape(m, length)  # every row full length, end to end
    finish_ms = device_ms(lambda: fused.finish_cuda(partials, blocks, 1, n, msgs, chals, dt.state, degree), 50,
                          "finish_kernel")
    # plain versions on the same shapes: torch on the card, the sponge on the CPU
    stacked = gf.GF2(s0, s1)
    idx = prover._factor_index(vp, degree, "cuda")
    r = gf.GF2(chals[0, 0], chals[1, 0])
    plain_round_ms = cuda_ms(lambda: prover._round_message(prover._fold_rows(stacked, r), idx, coeffs, degree), 2)
    dt_cpu = DeviceTranscript.from_host(BasicTranscript(b"timing"), "cpu")
    msg = gf.GF2(msgs[0, 0], msgs[1, 0])
    plain_finish_ms, _ = wall_ms(lambda: [dt_cpu.step(arr=msg, labels=(prover.ROUND_CHUNKS,), k=1)
                                          for _ in range(50)])
    plain_finish_ms /= 50
    # bounds: the round kernel moves its rows (16 bytes an element) once in
    # and their halves once out; a finish is one sponge call of 2(D + 1) + 2
    # absorbs and a squeeze of 2 words from a state with no pending input
    round_bytes = m * length * 16 * 1.5
    perms = sponge_permutations(2 * (degree + 1) + len(prover.ROUND_CHUNKS), 2)
    finish_bound = perms * 112 * chain_ns * 1e-6

    def time_finish_degree(d: int, rows: int) -> dict:
        """The finish at degree d on `rows` random partials (the maxpool
        zerocheck's degree, 5: 14 absorbs)."""
        from deepprove_tpu_torch.fields import host

        words = np.random.default_rng(8).integers(0, host.P, size=rows * 2 * (d + 1), dtype=np.uint64)
        part = gf.from_u64(words, "cuda")
        out = torch.empty((2, n, d + 1), dtype=torch.int64, device="cuda")
        ms = device_ms(lambda: fused.finish_cuda(part, rows, 1, n, out, chals, dt.state, d), 50, "finish_kernel")
        m_d = gf.GF2(gf.from_u64(words[0:2 * (d + 1):2], "cuda"), gf.from_u64(words[1:2 * (d + 1):2], "cuda"))
        plain, _ = wall_ms(lambda: [dt_cpu.step(arr=m_d, labels=(prover.ROUND_CHUNKS,), k=1) for _ in range(50)])
        p_d = sponge_permutations(2 * (d + 1) + len(prover.ROUND_CHUNKS), 2)
        return {"kernel_ms": ms, "plain_ms": plain / 50, "bound_ms": p_d * 112 * chain_ns * 1e-6,
                "bound_by": "operations", "blocks": rows, "permutations": p_d}

    finals = torch.empty((2, m), dtype=torch.int64, device="cuda")

    def time_tail(rounds: int) -> dict:
        """The tail's last `rounds` rounds (folding first) against the
        per-round prover; the bound: the larger of its rows' bytes (read
        once; the evaluations written once) and its `rounds` sponge calls in
        sequence, each a chain of dependent multiplies."""
        tail_len = 1 << (rounds + 1)
        t0, t1 = s0[:, :tail_len].contiguous(), s1[:, :tail_len].contiguous()
        words, other = fused.row_words(m, tail_len, n - rounds - 1, "cuda")
        y = torch.empty((2, other), dtype=torch.int64, device="cuda")
        # the work does not depend on the values, so the tail runs again on what it left
        tail_ms = device_ms(lambda: fused.tail_cuda((t0.reshape(-1), t1.reshape(-1)), (y[0], y[1]), words, m,
                                                    tail_len, n - rounds, n, fidx, coeffs, msgs, chals, dt.state,
                                                    finals, degree), 10, "tail_kernel")

        def plain_tail():
            """The tail's work by the per-round prover: the first fold, then
            `rounds` rounds (its absorb of [n, degree] one sponge call more)."""
            tail_vp = VirtualPolynomial.new(rounds)
            tail_vp.add_mle_rows(prover._fold_rows(gf.GF2(t0, t1), r))
            for f in products:
                tail_vp.add_product(None, f)
            tail_vp.coeffs_dev = coeffs
            return prover.prove_device(tail_vp, dt_cpu)

        plain_ms, _ = wall_ms(plain_tail)
        bytes_ms = (m * tail_len + m) * 16 / HBM_BYTES_PER_S * 1e3
        ops_ms = rounds * finish_bound
        return {"kernel_ms": tail_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
                "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "bound_ops_ms": ops_ms,
                "bound_bytes_ms": bytes_ms, "rounds": rounds, "row_length": tail_len,
                "grid": fused.tail_config(degree)}

    tail = time_tail(TIMED_TAIL_ROUNDS)
    extra = {}
    if fused.TAIL_LOG != TIMED_TAIL_ROUNDS:
        extra["tail_at_default"] = time_tail(fused.TAIL_LOG)
    ragged = time_round_ragged(gpt2_opening_shape())
    return {
        "timed_shape": {"num_vars": n, "rows": m, "products": len(products), "degree": degree},
        "round": {"kernel_ms": round_ms, "plain_ms": plain_round_ms,
                  "bound_ms": round_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
                  "blocks": blocks, "grid": grid, "ragged": ragged},
        "finish": {"kernel_ms": finish_ms, "plain_ms": plain_finish_ms, "bound_ms": finish_bound,
                   "bound_by": "operations", "blocks": blocks, "permutations": perms,
                   "degree_5": time_finish_degree(5, blocks),
                   # the finish kernel's shape while the round kernel's grid followed the rows
                   "at_1024_partials": time_finish_degree(2, 1024)},
        "tail": tail, **extra,
    }


def gpt2_opening_shape() -> dict:
    """GPT-2-124M's batch-opening sumcheck as phase gpt2 recorded it in this
    process (fused.LARGEST), else as tests/torch_reference.py
    GPT2_OPENING_CLAIMS records it (claims by their rows' log-length)."""
    import torch_reference as R

    if LARGEST_BY_PATH.get("gpt2", {}).get("rows"):
        return {**LARGEST_BY_PATH["gpt2"], "source": "phase gpt2"}
    rv = [lg for lg, claims in sorted(R.GPT2_OPENING_CLAIMS.items(), reverse=True) for _ in range(2 * claims)]
    return {"num_vars": max(rv), "row_vars": rv, "factors": [[2 * c, 2 * c + 1] for c in range(len(rv) // 2)],
            "degree": 2, "source": "torch_reference.GPT2_OPENING_CLAIMS"}


def time_round_ragged(big: dict) -> dict:
    """The round kernel at a path's largest stacked sumcheck (phase gpt2's:
    the batch opening, its rows at their own lengths), in its first folding
    round, on random device values as `check_largest` draws them; the finish
    kernel on that round's partials. The bound: the rows' own entries read
    once and their halves written once."""
    from deepprove_tpu_torch.fields import gf
    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    n, row_vars, factors, degree = big["num_vars"], big["row_vars"], big["factors"], big["degree"]
    st = fused.empty_stack(row_vars, "cuda")
    g = torch.Generator(device="cuda").manual_seed(9)
    for plane in st.first:
        plane.random_(0, 1 << 62, generator=g)  # canonical
    half = st.second()
    m, length = st.rows, st.length
    sched = fused.schedule(row_vars, factors, degree, n, "cuda")
    grid = fused.round_config(degree, sched.items, m)
    partials = torch.empty(grid["blocks"] * 2 * (degree + 1), dtype=torch.int64, device="cuda")
    c = torch.randint(0, 1 << 62, (2, len(factors)), generator=g, dtype=torch.int64, device="cuda")
    coeffs = gf.GF2(c[0], c[1])
    chals = torch.randint(0, 1 << 62, (2, n), generator=g, dtype=torch.int64, device="cuda")
    msgs = torch.empty((2, n, degree + 1), dtype=torch.int64, device="cuda")
    dt = DeviceTranscript.from_host(BasicTranscript(b"timing"), "cuda")

    def one_round():
        return fused.round_cuda(st.first, half, st.meta, m, 0, length, chals, 1, n, sched, coeffs, partials, degree)

    ms = device_ms(one_round, 5, "round_kernel")
    blocks = one_round()
    finish_ms = device_ms(lambda: fused.finish_cuda(partials, blocks, 1, n, msgs, chals, dt.state, degree), 50,
                          "finish_kernel")
    entries = sum(1 << lg for lg in row_vars)
    halves = sum(1 << max(lg - 1, 0) for lg in row_vars)
    result = {"kernel_ms": ms, "bound_ms": (entries + halves) * 16 / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
              "num_vars": n, "rows": m, "products": len(factors), "degree": degree, "entries": entries,
              "units": sched.work[1], "blocks": blocks, "grid": grid, "finish_ms": finish_ms,
              "source": big["source"]}
    del st, half
    torch.cuda.empty_cache()
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


def reset_launches() -> None:
    from deepprove_tpu_torch.hashing import poseidon2_cuda as pc
    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import device as devt

    pc.LAUNCHES = 0
    devt.LAUNCHES = 0
    for k in fused.LAUNCHES:
        fused.LAUNCHES[k] = 0


def read_launches() -> dict:
    """Kernel name -> launches since the last reset."""
    from deepprove_tpu_torch.hashing import poseidon2_cuda as pc
    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import device as devt

    return {"poseidon2_compress_level": pc.LAUNCHES, "sponge": devt.LAUNCHES, **fused.LAUNCHES}


def drive(name, model, x_np, want, pcs_kw, warm_runs):
    """The main path once (Model.run -> Context.generate -> Prover.prove ->
    verify) with every kernel's launch count set to 0 just before it and
    read after each step, the verifier rejecting a changed output, then
    `warm_runs` warm repeats, each with its transcript's host reads."""
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.zkml.iop import IO, Context, Prover, verify
    from deepprove_tpu_torch.zkml.tensor import Tensor

    from deepprove_tpu_torch.sumcheck import fused

    x = Tensor(torch.from_numpy(x_np))
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    fused.LARGEST.update(num_vars=0, rows=0, row_vars=[], entries=0, factors=[], degree=0)
    run_ms, trace = wall_ms(lambda: model.run([x], DEVICE))
    got = trace.outputs[0].data.cpu().numpy()
    assert np.array_equal(got[: len(want)], want), "inference differs from numpy"
    cold_setup_ms, ctx = wall_ms(lambda: Context.generate(model, device=DEVICE, **pcs_kw))
    after_setup = read_launches()
    prover = Prover(ctx, BasicTranscript(b"m2vec"), device=DEVICE)
    cold_prove_ms, proof = wall_ms(lambda: prover.prove(trace))
    after_prove = read_launches()
    cold_verify_ms, _ = wall_ms(
        lambda: verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"), device=DEVICE)
    )
    after_verify = read_launches()
    launches = {k: [after_setup[k], after_prove[k] - after_setup[k], after_verify[k] - after_prove[k]]
                for k in after_verify}
    for k, (_, in_prove, _) in launches.items():
        if in_prove == 0:
            raise AssertionError(f"the prove launched kernel {k} no time")

    bad = trace.outputs[0].data.clone()
    bad[0] += 1
    try:
        verify(ctx, proof, IO([x], [Tensor(bad)]), BasicTranscript(b"m2vec"), device=DEVICE)
    except AssertionError:
        pass  # the expected rejection
    else:
        raise AssertionError("verify accepted a changed output")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    largest = check_largest(name)

    warm = {"setup_ms": [], "prove_ms": [], "verify_ms": []}
    warm_pulls = []
    for _ in range(warm_runs):
        ms, ctx = wall_ms(lambda: Context.generate(model, device=DEVICE, **pcs_kw))
        warm["setup_ms"].append(ms)
        p = Prover(ctx, BasicTranscript(b"m2vec"), device=DEVICE)
        ms, proof = wall_ms(lambda: p.prove(trace))
        warm["prove_ms"].append(ms)
        warm_pulls.append(p.dt.pulls)
        ms, _ = wall_ms(
            lambda: verify(ctx, proof, IO([x], trace.outputs), BasicTranscript(b"m2vec"), device=DEVICE)
        )
        warm["verify_ms"].append(ms)

    result = {
        "phase": name, "ok": True, **pcs_kw, "inference_ms": run_ms,
        **{k: float(np.median(v)) for k, v in warm.items()},
        "warm_runs": warm, "cold_setup_ms": cold_setup_ms,
        "cold_prove_ms": cold_prove_ms, "cold_verify_ms": cold_verify_ms,
        "proof_field_elements": count_field_elements(proof),
        "launches_by_kernel": launches, "tampered_output_rejected": True,
        "transcript_pulls": prover.dt.pulls, "transcript_pulls_warm": warm_pulls,
        "largest_sumcheck": largest,
        "peak_mem_gib": peak_gib,
    }
    return result


LARGEST_BY_PATH: dict = {}  # path -> its largest stacked sumcheck's shape (fused.LARGEST), for kernel_times


def check_largest(name) -> dict:
    """The sumcheck kernels against the per-round prover at the path's
    stacked sumcheck with the most entries since the last reset
    (fused.LARGEST), its rows at their own lengths, random values."""
    from deepprove_tpu_torch.sumcheck import fused

    big = dict(fused.LARGEST)
    LARGEST_BY_PATH[name] = big
    largest = {"num_vars": big["num_vars"], "rows": big["rows"], "entries": big["entries"],
               "row_vars": sorted(set(big["row_vars"])), "products": len(big["factors"]), "degree": big["degree"],
               "rows_by_log_length": {lg: big["row_vars"].count(lg) for lg in sorted(set(big["row_vars"]))}}
    if big["rows"]:
        check = check_sumcheck({name: (big["num_vars"], big["rows"], big["factors"], big["degree"], None,
                                       big["row_vars"])})
        largest.update(mismatches=check["mismatches"], max_abs_err=check["max_abs_err"])
        if check["mismatches"]:
            raise AssertionError(f"the sumcheck kernels disagree at {name}'s largest shape: {largest}")
    return largest


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


def gpt2_ffn_model(cfg=None):
    """(model on the card, model input, prompt) of phase gpt2_ffn: GPT-2 at
    `cfg` (tests/torch_reference.py GPT2_FFN_CHIP by default) from the
    graph's Positional node through the feed-forward halves of blocks 0 and
    1 (`gpt2_ffn_graph`), the prompt and scales of bench.py's bench_gpt2."""
    import torch_reference as R

    from deepprove_tpu_torch.zkml import llm
    from deepprove_tpu_torch.zkml import model as model_mod
    from deepprove_tpu_torch.zkml.layers.embeddings import Positional

    cfg, seq = cfg or R.GPT2_FFN_CHIP, R.GPT2_124M_SEQ
    prompt = np.random.default_rng(0).integers(0, cfg["vocab"], size=seq // 2).astype(np.int64)
    _, model, x_np = R.gpt2_ffn_graph(llm, model_mod, Positional, cfg, seq, prompt,
                                      table=lambda a: torch.from_numpy(a).to(DEVICE), device=DEVICE)
    return model, x_np, prompt


def phase_gpt2_ffn():
    """The GPT-2 feed-forward path at width 128 (`gpt2_ffn_model`), its
    output held against a numpy evaluation of the same quantized graph."""
    import torch_reference as R

    build_ms, (model, x_np, prompt) = wall_ms(gpt2_ffn_model)
    want = R.numpy_eval_graph(R.graph_records(model), [x_np])
    result = {
        **drive("gpt2_ffn", model, x_np, want, PCS_KW, 1), "config": R.GPT2_FFN_CHIP,
        "seq": R.GPT2_124M_SEQ, "prompt_tokens": int(prompt.size), "build_ms": build_ms,
        "clamping_sizes": [model.nodes[n].op.spec.clamping_size() for n in model.forward_order()
                           if hasattr(model.nodes[n].op, "spec")],
        "layers": [type(model.nodes[n].op).__name__ for n in model.forward_order()],
    }
    emit(result)
    return result


# The gpt2 phase's peak device memory by step, predicted before its first
# run at GPT-2-124M's width (PERF.md section 6), in GiB.
GPT2_PEAK_PREDICTION_GIB = {"setup": 12.0, "prove": 60.0, "verify": 7.0}


def gpt2_model(cfg=None):
    """(model on the card, meta, prompt, tokens padded to seq) of phase
    gpt2: GPT2Builder.build of tests/torch_reference.py GPT2_CHIP's config
    (synthetic weights from seed 0), bench.py's seq and prompt."""
    import torch_reference as R

    from deepprove_tpu_torch.zkml import llm

    cfg, seq = cfg or R.GPT2_CHIP, R.GPT2_124M_SEQ
    prompt = np.random.default_rng(0).integers(0, cfg["vocab"], size=seq // 2).astype(np.int64)
    w = llm.GPT2Weights.synthetic(llm.LLMConfig(**cfg), seed=0)
    model, meta = llm.GPT2Builder(w, seq, device=DEVICE).build(prompt)
    toks = np.zeros(meta["seq"], dtype=np.int64)
    toks[: prompt.size] = prompt
    return model, meta, prompt, toks


def phase_gpt2():
    """GPT-2-124M's whole graph cut to two blocks (`gpt2_model`): setup,
    one generation step proved through Driver.step (cold, then warm),
    verify, the verifier rejecting a changed output; the output held
    against a numpy evaluation of the same quantized graph and the token
    against its argmax; every kernel's launches set to 0 just before the
    path and read after each step; each step's peak memory beside the
    prediction; the path's largest stacked sumcheck held against the
    per-round prover."""
    import torch_reference as R

    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.zkml import llm
    from deepprove_tpu_torch.zkml.iop import IO, Context, verify
    from deepprove_tpu_torch.zkml.tensor import Tensor

    build_ms, (model, meta, prompt, toks) = wall_ms(gpt2_model)
    want = R.numpy_eval_graph(R.graph_records(model), [toks])
    peak = {}

    def step(name, fn):
        torch.cuda.reset_peak_memory_stats()
        ms, out = wall_ms(fn)
        peak[name] = torch.cuda.max_memory_allocated() / 2**30
        return ms, out

    reset_launches()
    fused.LARGEST.update(num_vars=0, rows=0, row_vars=[], entries=0, factors=[], degree=0)
    setup_ms, ctx = step("setup", lambda: Context.generate(model, device=DEVICE, **PCS_KW))
    after_setup = read_launches()
    drv = llm.Driver(model, meta, ctx)
    cold_prove_ms, st = step("prove", lambda: drv.step(prompt, prove=True))
    after_prove = read_launches()
    got = st.trace.outputs[0].data.cpu().numpy()
    assert np.array_equal(got, want), "inference differs from numpy"
    token = st.token
    assert token == int(want[prompt.size - 1]), "the token is not the argmax at the last prompt position"
    x = Tensor(torch.from_numpy(toks))
    verify_ms, _ = step("verify", lambda: verify(ctx, st.proof, IO([x], st.trace.outputs), BasicTranscript(b"m2vec"),
                                                 device=DEVICE))
    after_verify = read_launches()
    launches = {k: [after_setup[k], after_prove[k] - after_setup[k], after_verify[k] - after_prove[k]]
                for k in after_verify}
    for k, (_, in_prove, _) in launches.items():
        if in_prove == 0:
            raise AssertionError(f"the prove launched kernel {k} no time")
    bad = st.trace.outputs[0].data.clone()
    bad[0] += 1
    try:
        verify(ctx, st.proof, IO([x], [Tensor(bad)]), BasicTranscript(b"m2vec"), device=DEVICE)
    except AssertionError:
        pass  # the expected rejection
    else:
        raise AssertionError("verify accepted a changed output")
    warm_prove_ms, _ = wall_ms(lambda: drv.step(prompt, prove=True))
    tables = {tt.name(): 1 << tt.multiplicity_poly_vars() for tt in sorted(ctx.lookup)}
    field_elements = count_field_elements(st.proof)
    del drv, ctx, st, bad  # the check's rows and the plain version's copies need the room
    largest = check_largest("gpt2")
    result = {
        "phase": "gpt2", "ok": True, **PCS_KW, "config": R.GPT2_CHIP, "seq": meta["seq"],
        "prompt_tokens": int(prompt.size), "token": token,
        "cut": "blocks 12 -> 2: from block 2 on the LayerNorm Requants' clamping tables reach 2^29 and 2^30 rows",
        "build_ms": build_ms, "setup_ms": setup_ms, "cold_prove_ms": cold_prove_ms, "prove_ms": warm_prove_ms,
        "verify_ms": verify_ms, "peak_mem_gib": peak, "peak_mem_predicted_gib": GPT2_PEAK_PREDICTION_GIB,
        "proof_field_elements": field_elements, "table_rows": tables,
        "clamping_sizes": [model.nodes[n].op.spec.clamping_size() for n in model.forward_order()
                           if hasattr(model.nodes[n].op, "spec")],
        "launches_by_kernel": launches, "tampered_output_rejected": True, "largest_sumcheck": largest,
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
    """The Dense chain, the Dense -> Requant -> ReLU chain, the small CNNs
    and the residual and transformer cases of the CPU tests, proved on the
    card: each proof must equal the JAX package's (the graphs' with their
    fan-out merges)."""
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
    for part, names, kw in (("residual", R.RESIDUAL_CASES, R.RESIDUAL_KW),
                            ("transformer", R.TRANSFORMER_CASES, R.TRANSFORMER_KW),
                            ("attention", R.ATTENTION_FROZEN, R.ATTENTION_KW)):
        for name in names:
            cases[f"{part}_{name}"] = (lambda name=name: R.port_graph(R.graph_case(name), DEVICE), kw,
                                       R.GRAPH_PROOF_PARTS, ref[part][name])
    equal = {}
    for name, (inputs, kw, parts, frozen) in cases.items():
        model, x_np = inputs()
        xs = [Tensor(torch.from_numpy(np.asarray(x, dtype=np.int64)))
              for x in (x_np if isinstance(x_np, list) else [x_np])]
        trace = model.run(xs, DEVICE)
        ctx = Context.generate(model, device=DEVICE, **kw)
        proof = Prover(ctx, BasicTranscript(b"m2vec"), device=DEVICE).prove(trace)
        verify(ctx, proof, IO(xs, trace.outputs), BasicTranscript(b"m2vec"), device=DEVICE)
        equal[name] = {p: R.plain(getattr(proof, p)) for p in parts} == frozen["proof"]
    ok = all(equal.values())
    emit({"phase": "reference", "ok": ok, "dims": {"dense": R.DENSE_DIMS, "mlp": R.MLP_DIMS},
          "equal_to_jax_proof": equal})
    if not ok:
        raise AssertionError(f"the card's proofs differ from the JAX package's: {equal}")


def phase_kernel_times() -> dict:
    """The sponge and sumcheck kernels' device times, from the profiler's
    records, beside their plain versions and bounds. It runs after the path
    phases: a process keeps paying for the profiler's instrumentation after
    it has run, and the paths' times must not carry that."""
    lat = product_latencies()
    result = {"phase": "kernel_times", "ok": True, **lat,
              "sponge": time_sponge(lat["chain_product_ns"]), **time_sumcheck(lat["chain_product_ns"])}
    emit(result)
    return result


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card, stats = phase_build()
    k = phase_kernels(stats["threads_per_block"])
    seconds = {"build_and_kernels": time.perf_counter() - t0}
    paths = []
    for name, phase in (("slice", phase_slice), ("mlp_4m", phase_mlp_4m), ("cnn", phase_cnn),
                        ("gpt2_ffn", phase_gpt2_ffn), ("gpt2", phase_gpt2)):
        torch.cuda.empty_cache()  # each path starts without the blocks the last one left cached
        t1 = time.perf_counter()
        paths.append(phase())
        seconds[name] = time.perf_counter() - t1
    t1 = time.perf_counter()
    phase_reference()
    seconds["reference"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    times = phase_kernel_times()
    seconds["kernel_times"] = time.perf_counter() - t1
    emit({"phase": "elapsed", "seconds": seconds, "total_s": time.perf_counter() - t0})
    by_path = {p["phase"]: p["launches_by_kernel"] for p in paths}
    cnn = by_path["cnn"]  # the main path: the kernels line's `launches` are its
    # the sumcheck kernels' largest disagreement: the kernels phase's cases
    # and each path's own largest shape
    sc_err = max([k["sumcheck"]["max_abs_err"]]
                 + [p["largest_sumcheck"].get("max_abs_err", 0) for p in paths])
    sc, sp = {**times, "max_abs_err": sc_err}, times["sponge"]
    res = stats["sponge_kernels"]
    mul = {k: times[k] for k in ("mul_latency_ns", "chain_product_ns")}
    tail = sc["tail"]
    rows = [
        ("poseidon2_compress_level", "poseidon2_compress.cu", "deepprove_tpu/hashing/poseidon2_pallas.py:142",
         {"kernel_ms": k["kernel_ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
          "bound_by": "operations" if k["bound_ops_ms"] >= k["bound_bytes_ms"] else "bytes"},
         k["max_abs_err"], {"sass_instructions": stats["sass_instructions"],
                            "resident_warps_per_sm": stats["resident_warps_per_sm"]}),
        ("sponge", "transcript.cu", "deepprove_tpu/transcript/device.py:60",
         {**sp, "bound_by": "operations"}, k["sponge"]["max_abs_err"],
         {**res["sponge_kernel"], **mul, "permutations": sp["permutations"]}),
        ("sumcheck_round", "sumcheck.cu", "deepprove_tpu/sumcheck/fused.py:164", sc["round"], sc["max_abs_err"],
         {**stats["round_kernel"], "partials": sc["round"]["blocks"], "grid_blocks": sc["round"]["grid"]["blocks"],
          **({"ragged_ms": rg["kernel_ms"], "ragged_bound_ms": rg["bound_ms"], "ragged_partials": rg["blocks"],
              "ragged_finish_ms": rg["finish_ms"], "ragged_rows": rg["rows"], "ragged_entries": rg["entries"]}
             if (rg := sc["round"]["ragged"]) else {})}),
        ("sumcheck_finish", "sumcheck.cu", "deepprove_tpu/sumcheck/fused.py:164", sc["finish"], sc["max_abs_err"],
         {**res["finish_kernel"], **mul, "partials": sc["finish"]["blocks"],
          "permutations": sc["finish"]["permutations"], "degree_5_ms": sc["finish"]["degree_5"]["kernel_ms"],
          "at_1024_partials_ms": sc["finish"]["at_1024_partials"]["kernel_ms"],
          "degree_5_bound_ms": sc["finish"]["degree_5"]["bound_ms"]}),
        ("sumcheck_tail", "sumcheck.cu", "deepprove_tpu/sumcheck/fused.py:64", tail, sc["max_abs_err"],
         {**res["tail_kernel"], **mul, "grid_blocks": tail["grid"]["blocks"],
          "threads_per_block": tail["grid"]["threads"], "rounds": tail["rounds"],
          "row_length": tail["row_length"], "bound_ops_ms": tail["bound_ops_ms"],
          "bound_bytes_ms": tail["bound_bytes_ms"]}),
    ]
    emit({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"deepprove_tpu_torch/csrc/{src}",
        "replaces": replaces,
        "launches": sum(cnn[name]),
        "launches_by_path": {path: by[name] for path, by in by_path.items()},
        "max_abs_err": err,
        "ms": t["kernel_ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
        **extra,
    } for name, src, replaces, t, err, extra in rows]})
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
