"""Proving context: per-node layer contexts, lookup tables + commitments.

`Context.generate` walks the model forward, calling each op's `step_info`
to build its verifier-side layer context and register its lookup tables
and polynomials, then commits them on the chosen device.
"""

from __future__ import annotations

import dataclasses

from ... import device as device_mod
from ..commit import CommitmentContext
from ..model import Model
from ..tensor import next_pow2


@dataclasses.dataclass
class ContextAux:
    tables: set = dataclasses.field(default_factory=set)
    model_polys: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class NodeCtx:
    node_id: int
    op: object  # the layer op (prover side)
    ctx: object  # the layer context (verifier side)
    inputs: list  # edges


class Context:
    def __init__(self, model: Model, steps_info, lookup, commitment_ctx, device):
        self.model = model
        self.steps_info = steps_info  # NodeId -> NodeCtx
        self.lookup = lookup  # sorted list of TableType
        self.commitment_ctx = commitment_ctx
        self.device = device

    @staticmethod
    def generate(model: Model, device="cuda", **pcs_kw) -> "Context":
        dev = device_mod.resolve(device)
        aux = ContextAux()
        steps_info = {}
        for nid in model.forward_order():
            node = model.nodes[nid]
            steps_info[nid] = NodeCtx(
                node_id=nid, op=node.op, ctx=node.op.step_info(nid, aux), inputs=node.inputs
            )
        lookup = sorted(aux.tables)
        max_len = 1
        for tt in lookup:
            max_len = max(max_len, 1 << tt.multiplicity_poly_vars())
        polys = {
            nid: {pid: p.to(dev) for pid, p in ps.items()}
            for nid, ps in aux.model_polys.items()
        }
        commitment_ctx = CommitmentContext(next_pow2(max_len), polys, lookup, device=dev, **pcs_kw)
        return Context(model, steps_info, lookup, commitment_ctx, dev)

    def forward_order(self):
        return sorted(self.steps_info)

    def backward_order(self):
        return sorted(self.steps_info, reverse=True)

    def write_to_transcript(self, transcript):
        self.commitment_ctx.write_to_transcript(transcript)
