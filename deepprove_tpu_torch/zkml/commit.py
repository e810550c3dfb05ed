"""Claim accumulation -> batched Basefold opening.

As in the JAX package's `zkml/commit.py`: `CommitmentContext` commits every
model weight poly at setup; `CommitmentProver` collects claims during the
backward proving pass, splits trivial (<= basecode vars) from batched, and
emits one batch opening; `CommitmentVerifier` mirrors it. Same-poly claim
merging (for fan-out) arrives with the slices whose models need it.
"""

from __future__ import annotations

import dataclasses

from ..lookup.logup import Claim
from ..pcs import basefold


class CommitmentContext:
    """Params + commitments for the model polys."""

    def __init__(self, max_poly_len: int, model_polys, **pcs_kw):
        """model_polys: {node_id: {poly_id: field tensor}} (little-endian)."""
        for polys in model_polys.values():
            for p in polys.values():
                max_poly_len = max(max_poly_len, p.shape[0])
        self.params = basefold.setup(max(1, (max_poly_len - 1).bit_length()), **pcs_kw)
        self.model_comms = {}
        for node_id in sorted(model_polys):
            self.model_comms[node_id] = {
                pid: (basefold.commit(self.params, poly), poly)
                for pid, poly in sorted(model_polys[node_id].items())
            }

    @property
    def trivial_num_vars(self) -> int:
        return self.params.basecode_msg_size_log

    def write_to_transcript(self, transcript):
        for node_id in sorted(self.model_comms):
            for pid in sorted(self.model_comms[node_id]):
                comm, _ = self.model_comms[node_id][pid]
                basefold.write_commitment(comm.commitment, transcript)


@dataclasses.dataclass
class _ProverClaim:
    comm: object  # CommitmentWithWitness
    poly: object
    claim: object  # glue.DevClaim


class CommitmentProver:
    def __init__(self, ctx: CommitmentContext):
        self.ctx = ctx
        self.claims: list[_ProverClaim] = []
        self.trivial: list[_ProverClaim] = []

    def add_witness_claim(self, comm_with_poly, claim):
        comm, poly = comm_with_poly
        entry = _ProverClaim(comm, poly, claim)
        if poly.shape[0].bit_length() - 1 <= self.ctx.trivial_num_vars:
            self.trivial.append(entry)
        else:
            self.claims.append(entry)

    def add_common_claims(self, node_id: int, claims: dict):
        """Model-poly claims keyed by poly id, added in sorted-id order."""
        for pid, (comm, poly) in self.ctx.model_comms[node_id].items():
            self.add_witness_claim((comm, poly), claims[pid])

    def prove(self, dt):
        """Open all accumulated claims against the session transcript."""
        params = self.ctx.params
        trivial = [basefold.open_session(params, c.comm, c.claim.point, dt) for c in self.trivial]
        batch = None
        if self.claims:
            batch = basefold.batch_open_session(
                params,
                [c.poly for c in self.claims],
                [c.comm for c in self.claims],
                [c.claim.point for c in self.claims],
                [
                    basefold.BatchEvaluation(poly=i, point=i, value=c.claim.eval)
                    for i, c in enumerate(self.claims)
                ],
                dt,
            )
        return {"batch": batch, "trivial": trivial}


@dataclasses.dataclass
class _VerifierClaim:
    commitment: object  # BasefoldCommitment
    claim: Claim


class CommitmentVerifier:
    def __init__(self, ctx: CommitmentContext):
        self.ctx = ctx
        self.claims: list[_VerifierClaim] = []
        self.trivial: list[_VerifierClaim] = []

    def add_witness_claim(self, commitment, claim: Claim):
        entry = _VerifierClaim(commitment, claim)
        if commitment.num_vars <= self.ctx.trivial_num_vars:
            self.trivial.append(entry)
        else:
            self.claims.append(entry)

    def add_common_claims(self, node_id: int, claims: dict):
        for pid, (comm, _) in self.ctx.model_comms[node_id].items():
            self.add_witness_claim(comm.commitment, claims[pid])

    def verify(self, proof, transcript, device):
        params = self.ctx.params
        assert len(proof["trivial"]) == len(self.trivial), "trivial proof count"
        for tp, tc in zip(proof["trivial"], self.trivial):
            basefold.verify(
                params, tc.commitment, tc.claim.point, tc.claim.eval, tp, transcript, device
            )
        if not self.claims:
            assert proof["batch"] is None
            return
        basefold.batch_verify(
            params,
            [c.commitment for c in self.claims],
            [c.claim.point for c in self.claims],
            [
                basefold.BatchEvaluation(poly=i, point=i, value=c.claim.eval)
                for i, c in enumerate(self.claims)
            ],
            proof["batch"],
            transcript,
            device,
        )
