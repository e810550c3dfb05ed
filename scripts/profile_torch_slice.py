#!/usr/bin/env python3
"""Where one prove of the port's Dense-chain slice spends its time on a GPU.

    python3 scripts/profile_torch_slice.py

Builds the chain [4, 1024, 1024, 3] as chip_smoke.py does, runs setup and a
warm prove, then:
  1. `components`: inclusive wall time and calls of the prove's main steps,
     each wrapped (in this script only) with a device synchronize on entry
     and exit, so queued device work is charged to the step that queued it;
  2. `profile`: one prove under torch.profiler (CUDA activity): kernel
     launches, summed kernel time, the device's busy share of an
     unprofiled warm prove, and the kernels that take the most time.
Prints one JSON line per part. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import inspect
import json
import os
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


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_torch_slice: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deepprove_tpu_torch import glue
    from deepprove_tpu_torch.pcs import basefold, merkle
    from deepprove_tpu_torch.sumcheck import prover as sc_prover
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.zkml import commit
    from deepprove_tpu_torch.zkml.convert import dense_chain_from_arrays
    from deepprove_tpu_torch.zkml.iop import Context, Prover
    from deepprove_tpu_torch.zkml.layers import dense
    from deepprove_tpu_torch.zkml.tensor import Tensor

    layers, x_np = cs.build_chain([4, 1024, 1024, 3], 0)
    model = dense_chain_from_arrays(layers, "cuda")
    trace = model.run([Tensor(torch.from_numpy(x_np))], "cuda")
    ctx = Context.generate(model, device="cuda", num_queries=200, basecode_msg_size_log=7)
    Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace)
    warm_ms, _ = cs.wall_ms(lambda: Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace))

    table = collections.defaultdict(lambda: [0.0, 0])
    targets = [
        (dense.Dense, "prove", "dense_layer"),
        (commit.CommitmentProver, "prove", "commit_open"),
        (sc_prover, "prove_device", "sumcheck"),
        (basefold, "_commit_phase_session", "basefold_commit_phase"),
        (basefold, "_query_openings", "basefold_query_openings"),
        (merkle.MerkleTree, "from_leaves", "merkle_tree"),
        (glue, "materialize", "materialize"),
    ]
    originals = [(o, n, _wrap(o, n, table, k)) for o, n, k in targets]
    dense.prove_device = sc_prover.prove_device  # bound by name at import
    total_ms, _ = cs.wall_ms(lambda: Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace))
    for owner, name, raw in originals:
        setattr(owner, name, raw)
    dense.prove_device = sc_prover.prove_device
    print(json.dumps({
        "part": "components", "warm_prove_ms": warm_ms, "synced_prove_ms": total_ms,
        "inclusive_ms": {k: v[0] * 1e3 for k, v in table.items()},
        "calls": {k: v[1] for k, v in table.items()},
    }), flush=True)

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace)
        torch.cuda.synchronize()
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rec = by_name[e.name[:160]]
            rec[0] += e.time_range.elapsed_us()
            rec[1] += 1
    kernel_us = sum(v[0] for v in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
    print(json.dumps({
        "part": "profile", "kernel_launches": sum(v[1] for v in by_name.values()),
        "kernel_ms": kernel_us / 1e3, "warm_prove_ms": warm_ms,
        "busy_share": kernel_us / 1e3 / warm_ms,
        "top": [{"kernel": k, "ms": v[0] / 1e3, "count": v[1]} for k, v in top],
        "card": cs.nvidia_smi("name,power.limit"),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
