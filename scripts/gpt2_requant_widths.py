#!/usr/bin/env python3
"""Each Requant of chip_smoke.py's `gpt2_ffn` graph at widths 128 to 768
(GPT-2-124M's): its intermediate bits, shift, multiplier and the size of
its clamping table, the table that sets the largest polynomial of the
graph's batch opening.

    python3 scripts/gpt2_requant_widths.py

The graph is built as the phase builds it (vocabulary 50257, context
1024, 12 blocks calibrated, heads of 64, seq 64, bench.py's prompt), on
the CPU and not proved; at 768 the calibration runs GPT-2-124M's float
forward, so run it where a few GiB of host memory are free. Prints one
JSON line: {width: [[bits, shift, multiplier, clamping-table bits], ...]},
the Requants in forward order.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def main() -> None:
    import chip_smoke as cs
    import torch_reference as R

    cs.DEVICE = "cpu"
    by_width = {}
    for emb in (128, 256, 512, 768):
        model = cs.gpt2_ffn_model(dict(R.GPT2_124M, emb=emb, heads=emb // 64))[0]
        by_width[emb] = [[op.spec.intermediate_bit_size, op.spec.shift, op.spec.multiplier, op.spec.clamping_size()]
                         for op in (model.nodes[n].op for n in model.forward_order()) if hasattr(op, "spec")]
    print(json.dumps(by_width), flush=True)


if __name__ == "__main__":
    main()
