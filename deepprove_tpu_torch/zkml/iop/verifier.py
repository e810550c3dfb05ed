"""Model verifier, as in the JAX package's `zkml/iop/verifier.py`.

Mirrors the prover's transcript: absorb the context, derive output claims,
verify each layer backwards, check input claims against the model input
MLEs, then verify the batched commitment opening. Host code, apart from
the Merkle path walk, which runs on `device`.
"""

from __future__ import annotations

import dataclasses

from ... import device as device_mod
from ...fields import gf, host
from ...lookup.logup import Claim
from ..commit import CommitmentVerifier
from .prover import claims_for_node


@dataclasses.dataclass
class IO:
    inputs: list  # Tensors
    outputs: list  # Tensors


class Verifier:
    def __init__(self, ctx, transcript):
        self.ctx = ctx
        self.transcript = transcript
        self.commit_verifier = CommitmentVerifier(ctx.commitment_ctx)


def _host_field(t):
    return gf.to_u64(t.to_field())


def verify(ctx, proof, io: IO, transcript, device="cuda"):
    """Raises AssertionError if `proof` does not prove `io` under `ctx`."""
    dev = device_mod.resolve(device)
    v = Verifier(ctx, transcript)
    ctx.write_to_transcript(transcript)

    out_claims = []
    for out in io.outputs:
        r = [transcript.read_challenge() for _ in range(out.num_vars())]
        out_claims.append(Claim(point=r, eval=host.mle_eval_v(_host_field(out), r)))

    claims_by_layer = {}
    out_nodes = ctx.model.output_nodes()
    for nid in ctx.backward_order():
        node_ctx = ctx.steps_info[nid]
        claims = claims_for_node(ctx.model, nid, claims_by_layer, out_claims, out_nodes)
        if node_ctx.ctx.is_provable:
            claims = node_ctx.ctx.verify(proof.steps[nid], claims, v)
        claims_by_layer[nid] = claims

    for nid in ctx.forward_order():
        for slot, edge in enumerate(ctx.steps_info[nid].inputs):
            if edge.node is None:
                claim = claims_by_layer[nid][slot]
                y = host.mle_eval_v(_host_field(io.inputs[edge.index]), claim.point)
                assert y == claim.eval, "input claim mismatch"

    v.commit_verifier.verify(proof.commit, transcript, dev)
