"""Model prover: the backward claim loop, as in the JAX package's
`zkml/iop/prover.py`.

Flow: absorb the context, derive output claims from Fiat-Shamir, walk the
DAG backwards proving each node, then emit one batched Basefold opening
for every accumulated claim. Claims and proof values stay on the device;
the proof is lowered to host ints in one pull at the end.
"""

from __future__ import annotations

import dataclasses

from ... import device as device_mod
from ... import glue
from ...poly import mle as mle_mod
from ...transcript.session import DeviceTranscript
from ..commit import CommitmentProver
from ..model import InferenceTrace


@dataclasses.dataclass
class Proof:
    steps: dict  # NodeId -> layer proof
    commit: dict  # {"batch": ..., "trivial": [...]}


class Prover:
    def __init__(self, ctx, transcript, device="cuda"):
        self.device = device_mod.resolve(device)
        if self.device != ctx.device:
            raise ValueError(f"context lives on {ctx.device}, prover asked for {self.device}")
        self.ctx = ctx
        self.transcript = transcript
        self.commit_prover = CommitmentProver(ctx.commitment_ctx)
        self.proofs = {}
        self.dt = None

    def push_proof(self, node_id, proof):
        self.proofs[node_id] = proof

    def prove(self, trace: InferenceTrace) -> Proof:
        self.ctx.write_to_transcript(self.transcript)
        self.dt = DeviceTranscript.from_host(self.transcript, self.device)

        out_claims = []
        for out in trace.outputs:
            r = self.dt.read_challenges(out.num_vars())
            out_claims.append(glue.DevClaim(point=r, eval=mle_mod.evaluate(out.to_field(), r)))

        claims_by_layer: dict[int, list] = {}
        out_nodes = self.ctx.model.output_nodes()
        for nid in self.ctx.backward_order():
            node_ctx = self.ctx.steps_info[nid]
            claims = claims_for_node(self.ctx.model, nid, claims_by_layer, out_claims, out_nodes)
            if node_ctx.op.is_provable:
                claims = node_ctx.op.prove(nid, node_ctx.ctx, claims, trace.steps[nid], self)
            claims_by_layer[nid] = claims

        proof = Proof(steps=self.proofs, commit=self.commit_prover.prove(self.dt))
        self.dt.sync_to_host(self.transcript)
        return glue.materialize(proof)


def claims_for_node(model, nid, claims_by_layer, out_claims, out_nodes):
    """One claim per output wire, from its consumer (or the model output).
    A wire feeding several consumers needs same-poly merging, which this
    slice of the port does not have."""
    claims = []
    for w in range(model.num_outputs(nid)):
        cands = []
        if nid in out_nodes and w == 0:
            cands.append(out_claims[out_nodes.index(nid)])
        for cid, slot in model.consumers_of_wire(nid, w):
            cands.append(claims_by_layer[cid][slot])
        if len(cands) != 1:
            raise NotImplementedError(
                f"node {nid} output {w} has {len(cands)} claims; fan-out needs "
                "same-poly merging, not in this slice of the port"
            )
        claims.append(cands[0])
    return claims
