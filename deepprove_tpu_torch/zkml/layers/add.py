"""Element-wise Add of two same-scale inputs, as in the JAX package's
`zkml/layers/add.py`.

y = x1 + x2 needs no sumcheck: the output claim y~(r) splits into the
claims x1~(r), which the prover evaluates, and x2~(r) = y~(r) - x1~(r); the
verifier checks that the two add up to the output claim.
"""

from __future__ import annotations

import dataclasses

from ... import glue
from ...fields import gf, host
from ...lookup.logup import Claim
from ...poly import mle as mle_mod
from ..tensor import Tensor


@dataclasses.dataclass
class Add:
    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(inputs[0].data + inputs[1].data)]

    def step_info(self, node_id: int, aux):
        return AddCtx(node_id=node_id)

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        pt = last_claims[0].point
        left_eval = mle_mod.evaluate(step_data.inputs[0].to_field(), pt)
        right_eval = gf.ext_sub(last_claims[0].eval, left_eval)
        prover.push_proof(node_id, AddProof(left_eval=left_eval, right_eval=right_eval))
        return [glue.DevClaim(point=pt, eval=left_eval), glue.DevClaim(point=pt, eval=right_eval)]


@dataclasses.dataclass
class AddProof:
    left_eval: object  # GF2 (); a host pair once materialized
    right_eval: object


@dataclasses.dataclass
class AddCtx:
    node_id: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: AddProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        assert host.ext_add(proof.left_eval, proof.right_eval) == last_claim.eval, "add split mismatch"
        return [
            Claim(point=list(last_claim.point), eval=proof.left_eval),
            Claim(point=list(last_claim.point), eval=proof.right_eval),
        ]
