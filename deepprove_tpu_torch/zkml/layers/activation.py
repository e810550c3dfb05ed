"""ReLU by table lookup, as in the JAX package's `zkml/layers/activation.py`.

The (input, output) pair of every element is looked up in the Relu table
(rows MIN - 1 ..= MAX) through the consolidated logup-GKR proofs; a
same-poly sumcheck binds the output column's lookup claim and the incoming
claim into one, and the input/output column claims go to the batched
opening. Gelu arrives with the transformer slice.
"""

from __future__ import annotations

import dataclasses

import torch

from ...lookup.logup import Claim
from .. import quantization as Q
from ..commit import SamePolyProof, same_poly_prove_device, same_poly_verify
from ..lookup_context import COLUMN_SEPARATOR, LogUpWitness, TableType, count_elements
from ..tensor import Tensor, next_pow2


def _padded(t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros(next_pow2(t.numel()), dtype=torch.int64, device=t.device)
    out[: t.numel()] = t
    return out


@dataclasses.dataclass
class Relu:
    shared_logup = True  # its lookups go into the consolidated logup proofs

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(inputs[0].data.clamp_min(0))]

    def shared_lookup_layout(self):
        return [(1, 2, TableType("relu"))]

    def step_info(self, node_id: int, aux):
        aux.tables.add(TableType("relu"))
        return ReluCtx(node_id=node_id)

    def gen_lookup_witness(self, node_id, ctx, step_data):
        inp = _padded(step_data.inputs[0].flat())
        out = _padded(step_data.outputs[0].flat())
        counts = count_elements(inp + out * COLUMN_SEPARATOR)
        cols = [Q.to_field(inp), Q.to_field(out)]
        wit = LogUpWitness(
            polys=cols,
            column_evals=cols, columns_per_instance=2, table_type=TableType("relu"),
        )
        return [wit], {TableType("relu"): counts}

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        (wit,) = prover.lookup_witnesses_for(node_id)
        input_claim, output_claim = prover.shared_claims_for(node_id, 0)
        acc_proof = same_poly_prove_device(
            wit.column_evals[1], [last_claims[0], output_claim], prover.dt
        )
        commits = []
        for (comm, poly), claim in zip(wit.commits, [input_claim, acc_proof.extract_claim()]):
            prover.commit_prover.add_witness_claim((comm, poly), claim)
            commits.append(comm.commitment)
        prover.push_proof(node_id, ActivationProof(io_accumulation=acc_proof, commits=commits))
        return [input_claim]


@dataclasses.dataclass
class ActivationProof:
    io_accumulation: SamePolyProof
    commits: list


@dataclasses.dataclass
class ReluCtx:
    node_id: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: ActivationProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        in_claim, out_claim = verifier.shared_logup_claims[(self.node_id, 0)]
        new_output_claim = same_poly_verify(
            proof.io_accumulation, [last_claim, out_claim], len(last_claim.point),
            verifier.transcript,
        )
        assert len(proof.commits) == 2, "relu commitment count"
        for commit, claim in zip(proof.commits, [in_claim, new_output_claim]):
            verifier.commit_verifier.add_witness_claim(commit, claim)
        return [in_claim]
