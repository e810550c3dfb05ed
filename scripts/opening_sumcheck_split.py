#!/usr/bin/env python3
"""The device time of GPT-2-124M's batch-opening sumcheck, by kernel, timed
on a GPU.

    python3 scripts/opening_sumcheck_split.py [TREE]

Lays out the opening's rows (tests/torch_reference.py GPT2_OPENING_CLAIMS:
an eq and a merged row a claim, 512 rows of 2^8-2^28 entries) as
`basefold.batch_open_session` does, fills them with random values on the
device, and proves them with `fused.prove_device` once to build and warm
the kernels and once under torch.profiler. Prints one JSON line: the
sumcheck's synchronized wall time and its device time and launches by
kernel (round, finish, tail, the rest), with the card's name and power
limit. TREE is an unpacked tree of the repo whose package is timed (for
example the parent's, from `git archive`); by default this one. The row
list always comes from this tree's tests. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("round_kernel", "finish_kernel", "tail_kernel")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("opening_sumcheck_split: no CUDA device is available", file=sys.stderr)
        return 2
    tree = os.path.abspath(argv[0]) if argv else ROOT
    sys.path.insert(0, tree)
    sys.path.insert(1, os.path.join(ROOT, "tests"))
    import torch_reference as R
    from torch.profiler import ProfilerActivity, profile

    from deepprove_tpu_torch.sumcheck import VirtualPolynomial, fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    row_vars = [lg for lg, claims in sorted(R.GPT2_OPENING_CLAIMS.items(), reverse=True) for _ in range(2 * claims)]
    n = max(row_vars)
    g = torch.Generator(device="cuda").manual_seed(11)

    def rows():
        st = fused.empty_stack(row_vars, "cuda")
        for plane in st.first:
            plane.random_(0, 1 << 62, generator=g)  # canonical
        vp = VirtualPolynomial.new(n)
        for c in range(len(row_vars) // 2):
            vp.add_product((1, 0), [vp.add_mle(st.row(2 * c)), vp.add_mle(st.row(2 * c + 1))])
        dt = DeviceTranscript.from_host(BasicTranscript(b"opening"), "cuda")
        torch.cuda.synchronize()
        return vp, dt, st

    def prove(vp, dt, st):
        t0 = time.perf_counter()
        fused.prove_device(vp, dt, stacked=st)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prove(*rows())  # builds the kernels; the rounds overwrite the rows
    args = rows()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        wall_ms = prove(*args)
    split = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kind = next((k for k in KINDS if k in e.name()), "other")
            split[kind][0] += e.duration_ns() / 1e6
            split[kind][1] += 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(json.dumps({
        "part": "opening_sumcheck_split", "tree": os.path.relpath(tree, ROOT), "card": card,
        "num_vars": n, "rows": len(row_vars), "entries": sum(1 << lg for lg in row_vars),
        "wall_ms": wall_ms, "device_ms": sum(v[0] for v in split.values()),
        "by_kernel": {k: {"ms": v[0], "launches": v[1]} for k, v in sorted(split.items())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
