#!/usr/bin/env python3
"""Where the fused sumcheck's tail should start (`sumcheck/fused.py`
TAIL_LOG), measured on a GPU.

    python3 scripts/sweep_tail_log.py [first last]

For each tail start from `first` to `last` (8 to 14 by default) prints one
JSON line:
  - `shapes`: the device time (the profiler's kernel records, stacking
    included) and the launches of one fused sumcheck at each of
    chip_smoke.py's main-path shapes (`sumcheck_cases`, without the edge
    shapes), the mean of 3;
  - `paths`: for the LeNet and Dense-4M (chip_smoke.py's `cnn` and
    `mlp_4m`), the median wall time of 2 warm proves, then one more warm
    prove with every sumcheck synchronized on entry and exit: the
    sumchecks' inclusive time and their kernel launches.
The tail starts take turns within each repeat, so that drift spreads over
all of them; the proves run before the profiled shapes, since the
profiler slows the rest of a process. Needs a CUDA device.
"""

from __future__ import annotations

import collections
import json
import os
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(1, os.path.join(ROOT, "tests"))
sys.path.insert(2, os.path.join(ROOT, "scripts"))

MAIN_SHAPES = ("logup_level_2^13", "logup_level_39_instances", "batch_open_2^20", "maxpool_zerocheck",
               "maxpool_zerocheck_2^12")
PROVES = 2  # unwrapped warm proves a tail start and path


def shape_times(cs, tail_logs) -> dict:
    """Tail start -> shape -> (device ms, launches) of one fused sumcheck."""
    from torch.profiler import ProfilerActivity, profile

    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.transcript.session import DeviceTranscript

    cases = cs.sumcheck_cases()
    out = collections.defaultdict(dict)
    for i, name in enumerate(MAIN_SHAPES):
        n, rows, products, degree, *_ = cases[name]
        vp = cs.random_vp(n, rows, products, 200 + i, "cuda")
        for tl in tail_logs:
            fused.TAIL_LOG = tl

            def run():
                fused.prove_device(vp, DeviceTranscript.from_host(BasicTranscript(b"sweep"), "cuda"))

            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    run()
                torch.cuda.synchronize()
            durs = [e.duration_ns() for e in prof.profiler.kineto_results.events()
                    if e.device_type() == torch.autograd.DeviceType.CUDA]
            out[tl][name] = {"device_ms": sum(durs) / 3 / 1e6, "launches": len(durs) / 3}
        del vp
        torch.cuda.empty_cache()
    return out


class SumcheckTimer:
    """Wraps fused.prove_device, and every module's binding of it, with a
    device synchronize on entry and exit; sums the wall time."""

    def __init__(self):
        from deepprove_tpu_torch import sumcheck as sumcheck_pkg
        from deepprove_tpu_torch.lookup import logup
        from deepprove_tpu_torch.sumcheck import fused
        from deepprove_tpu_torch.zkml import commit
        from deepprove_tpu_torch.zkml.layers import convolution, dense, pooling, requant

        self.fused = fused
        self.mods = (fused, sumcheck_pkg, logup, commit, convolution, dense, pooling, requant)
        self.plain = fused.prove_device
        self.seconds = 0.0

    def __enter__(self):
        plain = self.plain

        def timed(vp, dt):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = plain(vp, dt)
            torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            return out

        for mod in self.mods:
            mod.prove_device = timed
        return self

    def __exit__(self, *exc):
        for mod in self.mods:
            mod.prove_device = self.plain


def path_times(cs, tail_logs) -> dict:
    """Tail start -> path -> warm prove and sumcheck numbers."""
    import profile_torch_slice as pts

    from deepprove_tpu_torch.sumcheck import fused
    from deepprove_tpu_torch.transcript import BasicTranscript
    from deepprove_tpu_torch.zkml.iop import Context, Prover
    from deepprove_tpu_torch.zkml.tensor import Tensor

    out = collections.defaultdict(dict)
    for path in ("cnn", "mlp"):
        model, x_np = pts.build_path(cs, path)
        trace = model.run([Tensor(torch.from_numpy(x_np))], "cuda")
        ctx = Context.generate(model, device="cuda", **cs.PCS_KW)

        def prove():
            return Prover(ctx, BasicTranscript(b"m2vec"), device="cuda").prove(trace)

        prove()  # warm
        runs = collections.defaultdict(list)
        for _ in range(PROVES):
            for tl in tail_logs:
                fused.TAIL_LOG = tl
                runs[tl].append(cs.wall_ms(prove)[0])
        for tl in tail_logs:
            fused.TAIL_LOG = tl
            cs.reset_launches()
            with SumcheckTimer() as timer:
                prove()
            launches = cs.read_launches()
            out[tl][path] = {
                "prove_ms": statistics.median(runs[tl]), "prove_runs_ms": runs[tl],
                "sumcheck_inclusive_ms": timer.seconds * 1e3,
                "sumcheck_launches": sum(v for k, v in launches.items() if k.startswith("sumcheck")),
            }
        del model, trace, ctx
        torch.cuda.empty_cache()
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("sweep_tail_log: no CUDA device is available", file=sys.stderr)
        return 2
    import chip_smoke as cs

    from deepprove_tpu_torch.sumcheck import fused

    first, last = (int(argv[0]), int(argv[1])) if argv else (8, 14)
    tail_logs = list(range(first, last + 1))
    default = fused.TAIL_LOG
    # the proves first: the profiler that times the shapes slows the rest of a process
    paths = path_times(cs, tail_logs)
    shapes = shape_times(cs, tail_logs)
    fused.TAIL_LOG = default
    card = cs.nvidia_smi("name,power.limit")
    for tl in tail_logs:
        print(json.dumps({"tail_log": tl, "shapes": shapes[tl], "paths": paths[tl], "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
