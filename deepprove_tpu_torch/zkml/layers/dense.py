"""Dense (fully-connected) layer y = Wx + b, proven with one degree-2
sumcheck, as in the JAX package's `zkml/layers/dense.py`.

The verifier subtracts bias~(r) from the output claim; the prover fixes r
into the matrix MLE's high (row) variables, then sumchecks
sum_j W(r, j) x(j). The weight claim lands at (sumcheck point ++ r), the
bias claim at r; both go to the commitment accumulator. The claim passed
to the previous layer is (sumcheck point, x~(point)).
"""

from __future__ import annotations

import dataclasses

import torch

from ... import glue
from ...fields import host
from ...lookup.logup import Claim
from ...poly import mle as mle_mod
from ...sumcheck import VirtualPolynomial, prove_device
from ...sumcheck import verify as sumcheck_verify
from .. import quantization as Q
from ..tensor import Tensor, ceil_log2, pad_matrix_pow2

WEIGHT_POLY_ID = "weight"
BIAS_POLY_ID = "bias"


@dataclasses.dataclass
class Dense:
    """Quantized dense layer; matrix/bias int64 tensors padded to powers of two."""

    matrix: torch.Tensor  # (rows, cols)
    bias: torch.Tensor  # (rows,)

    def __post_init__(self):
        self.matrix = pad_matrix_pow2(self.matrix.to(torch.int64))
        b = torch.zeros(self.matrix.shape[0], dtype=torch.int64, device=self.matrix.device)
        b[: self.bias.numel()] = self.bias.to(device=b.device, dtype=torch.int64)
        self.bias = b

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = inputs[0].flat()
        xp = torch.zeros(self.matrix.shape[1], dtype=torch.int64, device=x.device)
        xp[: x.numel()] = x
        # integer matmul as a product + row sum: CUDA has no int64 matmul
        return [Tensor((self.matrix * xp).sum(dim=1) + self.bias)]

    def output_bitsize(self) -> int:
        """2 (BIT_LEN - 1) + log2(cols) + 1: the bits an output can need."""
        return 2 * (Q.BIT_LEN - 1) + ceil_log2(self.matrix.shape[1]) + 1

    # -- context ------------------------------------------------------------
    def step_info(self, node_id: int, aux):
        aux.model_polys[node_id] = {
            WEIGHT_POLY_ID: Q.to_field(self.matrix.reshape(-1)),
            BIAS_POLY_ID: Q.to_field(self.bias),
        }
        return DenseCtx(node_id=node_id, nrows=self.matrix.shape[0], ncols=self.matrix.shape[1])

    # -- proving ------------------------------------------------------------
    def prove(self, node_id: int, ctx, last_claims, step_data, prover):
        pt = last_claims[0].point  # GF2 (row vars,)
        comms = prover.ctx.commitment_ctx.model_comms[node_id]
        bias_eval = mle_mod.evaluate(comms[BIAS_POLY_ID][1], pt)
        w_fixed = mle_mod.fix_high_variables(comms[WEIGHT_POLY_ID][1], pt)
        x = step_data.inputs[0].to_field()

        vp = VirtualPolynomial.new(x.shape[0].bit_length() - 1)
        vp.add_product((1, 0), [vp.add_mle(w_fixed), vp.add_mle(x)])
        out = prove_device(vp, prover.dt)

        prover.commit_prover.add_common_claims(
            node_id,
            {
                WEIGHT_POLY_ID: glue.DevClaim(
                    point=glue.concat_points([out.proof.point, pt]),
                    eval=glue.at(out.final_evals, 0),
                ),
                BIAS_POLY_ID: glue.DevClaim(point=pt, eval=bias_eval),
            },
        )
        prover.push_proof(
            node_id,
            DenseProof(sumcheck=out.proof, bias_eval=bias_eval, individual_claims=out.final_evals),
        )
        return [glue.DevClaim(point=out.proof.point, eval=glue.at(out.final_evals, 1))]


@dataclasses.dataclass
class DenseProof:
    sumcheck: object
    bias_eval: object
    individual_claims: object


@dataclasses.dataclass
class DenseCtx:
    node_id: int
    nrows: int
    ncols: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: DenseProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        eval_no_bias = host.ext_sub(last_claim.eval, proof.bias_eval)
        sub = sumcheck_verify(
            eval_no_bias, proof.sumcheck.round_messages, ceil_log2(self.ncols), 2,
            verifier.transcript,
        )
        verifier.commit_verifier.add_common_claims(
            self.node_id,
            {
                WEIGHT_POLY_ID: Claim(
                    point=list(sub.point) + list(last_claim.point),
                    eval=proof.individual_claims[0],
                ),
                BIAS_POLY_ID: Claim(point=list(last_claim.point), eval=proof.bias_eval),
            },
        )
        got = host.ext_mul(proof.individual_claims[0], proof.individual_claims[1])
        assert got == sub.expected_evaluation, "dense sumcheck final mismatch"
        return [Claim(point=list(sub.point), eval=proof.individual_claims[1])]
