"""ReLU and GELU by table lookup, as in the JAX package's
`zkml/layers/activation.py`.

The (input, output) pair of every element is looked up in the Relu or the
gelu table (rows MIN - 1 ..= MAX) through the consolidated logup-GKR
proofs; a same-poly sumcheck binds the output column's lookup claim and
the incoming claim into one, and the input/output column claims go to the
batched opening. The gelu table's output column is committed at setup.
"""

from __future__ import annotations

import dataclasses

import torch

from ...lookup.logup import Claim
from .. import quantization as Q
from ..commit import SamePolyProof, same_poly_prove_device, same_poly_verify
from ..lookup_context import COLUMN_SEPARATOR, LogUpWitness, TableType, gelu_rows, gelu_table_type
from ..tensor import Tensor, pad_vec_pow2


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
        inp = pad_vec_pow2(step_data.inputs[0].flat())
        out = pad_vec_pow2(step_data.outputs[0].flat())
        looked_up = inp + out * COLUMN_SEPARATOR
        cols = [Q.to_field(inp), Q.to_field(out)]
        wit = LogUpWitness(
            polys=cols,
            column_evals=cols, columns_per_instance=2, table_type=TableType("relu"),
        )
        return [wit], {TableType("relu"): looked_up}

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        return _prove_lookup_activation(node_id, last_claims, prover)


def _prove_lookup_activation(node_id, last_claims, prover):
    """Bind the incoming claim and the output column's lookup claim into one
    (same-poly), then both columns' claims to their commitments."""
    (wit,) = prover.lookup_witnesses_for(node_id)
    input_claim, output_claim = prover.shared_claims_for(node_id, 0)
    acc_proof = same_poly_prove_device(wit.column_evals[1], [last_claims[0], output_claim], prover.dt)
    commits = []
    for (comm, poly), claim in zip(wit.commits, [input_claim, acc_proof.extract_claim()]):
        prover.commit_prover.add_witness_claim((comm, poly), claim)
        commits.append(comm.commitment)
    prover.push_proof(node_id, ActivationProof(io_accumulation=acc_proof, commits=commits))
    return [input_claim]


@dataclasses.dataclass
class Gelu:
    """Quantized GELU through the gelu table at input and output scales
    s_in and s_out (its output column committed, its claim routed through
    the table claims)."""

    s_in: float
    s_out: float
    # the table's output column by device, each built once at first use
    _out: dict = dataclasses.field(default_factory=dict, init=False, repr=False, compare=False)
    shared_logup = True  # its lookups go into the consolidated logup proofs

    @property
    def table_type(self) -> TableType:
        return gelu_table_type(self.s_in, self.s_out)

    def _table_out(self, device) -> torch.Tensor:
        key = torch.device(device)
        if key not in self._out:
            self._out[key] = torch.from_numpy(gelu_rows(self.table_type.params)[1]).to(key)
        return self._out[key]

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = inputs[0].data
        return [Tensor(self._table_out(x.device)[x - (Q.MIN - 1)])]

    def shared_lookup_layout(self):
        return [(1, 2, self.table_type)]

    def step_info(self, node_id: int, aux):
        aux.tables.add(self.table_type)
        return GeluCtx(node_id=node_id, s_in=self.s_in, s_out=self.s_out)

    def gen_lookup_witness(self, node_id, ctx, step_data):
        flat = step_data.inputs[0].flat()
        inp = pad_vec_pow2(flat)
        out = pad_vec_pow2(step_data.outputs[0].flat())
        # padded inputs are 0: their output is the table's row for 0
        out[flat.numel() :] = self._table_out(out.device)[-(Q.MIN - 1)]
        looked_up = inp + out * COLUMN_SEPARATOR
        cols = [Q.to_field(inp), Q.to_field(out)]
        wit = LogUpWitness(polys=cols, column_evals=cols, columns_per_instance=2, table_type=self.table_type)
        return [wit], {self.table_type: looked_up}

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        return _prove_lookup_activation(node_id, last_claims, prover)


@dataclasses.dataclass
class ActivationProof:
    io_accumulation: SamePolyProof
    commits: list


def _verify_lookup_activation(node_id, proof: ActivationProof, last_claims, verifier) -> list[Claim]:
    last_claim = last_claims[0]
    in_claim, out_claim = verifier.shared_logup_claims[(node_id, 0)]
    new_output_claim = same_poly_verify(
        proof.io_accumulation, [last_claim, out_claim], len(last_claim.point), verifier.transcript,
    )
    assert len(proof.commits) == 2, "activation commitment count"
    for commit, claim in zip(proof.commits, [in_claim, new_output_claim]):
        verifier.commit_verifier.add_witness_claim(commit, claim)
    return [in_claim]


@dataclasses.dataclass
class ReluCtx:
    node_id: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: ActivationProof, last_claims, verifier) -> list[Claim]:
        return _verify_lookup_activation(self.node_id, proof, last_claims, verifier)


@dataclasses.dataclass
class GeluCtx:
    node_id: int
    s_in: float
    s_out: float

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: ActivationProof, last_claims, verifier) -> list[Claim]:
        return _verify_lookup_activation(self.node_id, proof, last_claims, verifier)
