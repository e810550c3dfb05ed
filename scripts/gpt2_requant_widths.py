#!/usr/bin/env python3
"""Each Requant of GPT-2's whole graph (`GPT2Builder.build`, Embeddings to
Logits) at widths 128 to 768 (GPT-2-124M's) and at 1, 2 and 12 blocks:
its intermediate bits, shift and the size of its clamping table; the
softmax tables' sizes; and the graph's largest polynomial. The clamping
tables set the largest polynomial of a prove's batch opening, and so how
deep a 768-wide GPT-2 can go on one card.

    python3 scripts/gpt2_requant_widths.py [width ...]

The graph is built as chip_smoke.py's phase gpt2 builds it (vocabulary
50257, context 1024, heads of 64, synthetic weights from seed 0, seq 64,
bench.py's prompt), on the CPU and not proved; at 768 and 12 blocks the
weights and the calibration's float forward take some GiB of host memory.
Prints one JSON line a (width, blocks): each Requant as [bits, shift,
clamping-table bits] in forward order, the softmax tables as
{name: rows}, the largest polynomial's entries and what it is.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))


def summary(model) -> dict:
    """The Requants' [bits, shift, clamping bits], the softmax tables, and
    the largest polynomial: a clamping table's multiplicities, a weight,
    or the lm_head's output columns."""
    requants, softmax, sizes = [], {}, {}
    for n in model.forward_order():
        op = model.nodes[n].op
        kind = type(op).__name__
        if kind == "Requant":
            s = op.spec
            requants.append([s.intermediate_bit_size, s.shift, s.clamping_size()])
            sizes[f"clamping table 2^{s.clamping_size()}"] = 1 << s.clamping_size()
        elif kind == "Softmax":
            for tt in (op.exp_table, op.error_table, op.zero_table):
                if tt is not None:
                    softmax[tt.name()] = 1 << tt.multiplicity_poly_vars()
        for f in ("table", "right_const"):
            t = getattr(op, f, None)
            if t is not None:
                sizes[f"{kind} {f} {tuple(t.shape)}"] = t.numel()
    name = max(sizes, key=sizes.get)
    return {"requants": requants, "softmax_tables": softmax, "largest_poly": [name, sizes[name]]}


def main(argv) -> None:
    import chip_smoke as cs
    import torch_reference as R

    cs.DEVICE = "cpu"
    for emb in [int(a) for a in argv] or (128, 256, 512, 768):
        for blocks in (1, 2, 12):
            model = cs.gpt2_model(dict(R.GPT2_124M, emb=emb, heads=emb // 64, blocks=blocks))[0]
            print(json.dumps({"width": emb, "blocks": blocks, **summary(model)}), flush=True)
            del model


if __name__ == "__main__":
    main(sys.argv[1:])
