"""Two trees of the repo on one card, in turns: phases mlp_4m and cnn of
each tree's chip_smoke.py, run as A, B, B, A, each turn in a process of
its own (its warm prove medians, launches and peak memory printed); with
--kernels, phase kernel_times of each tree (the sponge and sumcheck
kernels' device times) as A, B, B, A; with --gpt2, phase gpt2 of each
tree as A, B, each with its peak reserved memory. --no-paths leaves out
mlp_4m and cnn. Times differ between calls to the card: compare only
within one run.

    python3 scripts/compare_trees.py A_DIR B_DIR [--kernels] [--gpt2] [--no-paths] [--out DIR]

A_DIR and B_DIR are unpacked trees (e.g. `git archive <commit>`), each
building its kernels into its own `_build`. The allocator runs with its
default settings unless PYTORCH_CUDA_ALLOC_CONF is set. Full logs go to
DIR (default `compare_logs/` at the repo's root).
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BUILD = "from deepprove_tpu_torch import kernels, native; kernels.build(); native.get_lib()"
PATHS = r'''
import json, chip_smoke as c
c.phase_build()
r = {}
for f in (c.phase_mlp_4m, c.phase_cnn):
    x = f()
    r[x["phase"]] = {k: x[k] for k in ("prove_ms", "warm_runs", "cold_prove_ms", "setup_ms", "verify_ms",
                                       "launches_by_kernel", "peak_mem_gib", "transcript_pulls")}
print("SUMMARY " + json.dumps(r), flush=True)
'''
KERNELS = r'''
import json, chip_smoke as c
c.phase_build()
x = c.phase_kernel_times()
print("SUMMARY " + json.dumps({k: x[k] for k in ("round", "finish", "tail")}, default=str), flush=True)
'''
GPT2 = r'''
import json, torch, chip_smoke as c
c.phase_build()
try:
    x = c.phase_gpt2()
    print("SUMMARY " + json.dumps({k: v for k, v in x.items() if k != "launches_by_kernel"}, default=str), flush=True)
finally:
    print("RESERVED_MAX_GIB", torch.cuda.max_memory_reserved() / 2**30, flush=True)
'''


def run(out: str, tag: str, tree: str, code: str, timeout: int) -> None:
    t = time.perf_counter()
    with open(os.path.join(out, tag + ".log"), "w") as log:
        p = subprocess.run([sys.executable, "-c", code], cwd=tree, stdout=subprocess.PIPE, stderr=log,
                           text=True, timeout=timeout)
        log.write(p.stdout)
    print(tag, "rc", p.returncode, "s", round(time.perf_counter() - t, 2), flush=True)
    for line in p.stdout.splitlines():
        if line.startswith(("SUMMARY", "RESERVED")):
            print(line, flush=True)


def main() -> int:
    args = sys.argv[1:]
    a, b = (os.path.abspath(d) for d in args[:2])
    out = os.path.abspath(args[args.index("--out") + 1]) if "--out" in args else os.path.join(ROOT, "compare_logs")
    os.makedirs(out, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print("PYTORCH_CUDA_ALLOC_CONF:", os.environ.get("PYTORCH_CUDA_ALLOC_CONF"), flush=True)
    t0 = time.perf_counter()
    builds = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=t) for t in (a, b)]
    print("build rcs", [p.wait() for p in builds], round(time.perf_counter() - t0, 2), flush=True)
    turns = (("A", a), ("B", b), ("B", b), ("A", a))
    if "--no-paths" not in args:
        for i, (tag, tree) in enumerate(turns):
            run(out, f"{i}_{tag}", tree, PATHS, 400)
    if "--kernels" in args:
        for i, (tag, tree) in enumerate(turns):
            run(out, f"kernels_{i}_{tag}", tree, KERNELS, 400)
    if "--gpt2" in args:
        for tag, tree in turns[:2]:
            run(out, f"gpt2_{tag}", tree, GPT2, 600)
    print("total s", round(time.perf_counter() - t0, 2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
