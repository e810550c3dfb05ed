"""MatMul: C = A B (+ bias) with witness or constant operands, as in the
JAX package's `zkml/layers/matmul.py`.

One degree-2 sumcheck over the contracted axis: the output claim
C~(r_col, r_row) (minus bias~(r_col) when there is a bias) reduces to
sum_k A(r_row, k) B(k, r_col). Little-endian 2D MLEs put the column
variables low, so A fixes r_row into its high variables and B fixes r_col
into its low ones. A constant operand's final evaluation becomes a claim on
its committed polynomial; a witness operand's claim goes to its producer.
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
from ..tensor import Tensor, ceil_log2, pad_matrix_pow2, pad_vec_pow2

LEFT_POLY_ID = "left"
RIGHT_POLY_ID = "right"
BIAS_POLY_ID = "bias"

# elements of the (rows, k, n) product a chunk of rows forms at once
_CHUNK_ELEMS = 1 << 26


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in int64 (CUDA has no integer matmul): products and a sum over
    k, a chunk of a's rows at a time."""
    m, k = a.shape
    rows = max(1, _CHUNK_ELEMS // max(1, k * b.shape[1]))
    return torch.cat([(a[i : i + rows, :, None] * b[None]).sum(dim=1) for i in range(0, m, rows)])


@dataclasses.dataclass
class MatMul:
    """C[m, n] = A[m, k] B[k, n] (+ bias[n]); a constant operand is an int64
    tensor (committed at setup), None a witness input."""

    left_const: torch.Tensor | None = None
    right_const: torch.Tensor | None = None
    bias: torch.Tensor | None = None

    def __post_init__(self):
        assert self.left_const is None or self.right_const is None, "constant x constant matmul"
        if self.left_const is not None:
            self.left_const = pad_matrix_pow2(self.left_const.to(torch.int64))
        if self.right_const is not None:
            self.right_const = pad_matrix_pow2(self.right_const.to(torch.int64))
        if self.bias is not None:
            self.bias = pad_vec_pow2(self.bias.to(torch.int64))

    @staticmethod
    def new_constant(right: torch.Tensor, bias: torch.Tensor | None = None) -> "MatMul":
        """X @ W (+ bias) with a committed weight."""
        return MatMul(right_const=right, bias=bias)

    @property
    def is_provable(self) -> bool:
        return True

    def _operands(self, inputs: list[Tensor]):
        it = iter(inputs)
        a = self.left_const if self.left_const is not None else next(it).data.to(torch.int64)
        b = self.right_const if self.right_const is not None else next(it).data.to(torch.int64)
        return a, b

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        a, b = self._operands(inputs)
        # a witness operand is padded to the constant's contracted size
        if self.left_const is None and self.right_const is not None and a.shape[1] != b.shape[0]:
            a = torch.nn.functional.pad(a, (0, b.shape[0] - a.shape[1]))
        if self.right_const is None and self.left_const is not None and b.shape[0] != a.shape[1]:
            b = torch.nn.functional.pad(b, (0, 0, 0, a.shape[1] - b.shape[0]))
        c = int_matmul(a, b)
        if self.bias is not None:
            c = c + self.bias[None, : c.shape[1]]
        # outputs are padded in both dims, so downstream claim points split cleanly
        return [Tensor(pad_matrix_pow2(c))]

    def output_bitsize(self) -> int:
        if self.right_const is not None:
            k = self.right_const.shape[0]
        elif self.left_const is not None:
            k = self.left_const.shape[1]
        else:
            k = 1 << 12
        return 2 * (Q.BIT_LEN - 1) + ceil_log2(max(2, k)) + 1

    def step_info(self, node_id: int, aux):
        polys = {}
        if self.left_const is not None:
            polys[LEFT_POLY_ID] = Q.to_field(self.left_const.reshape(-1))
        if self.right_const is not None:
            polys[RIGHT_POLY_ID] = Q.to_field(self.right_const.reshape(-1))
        if self.bias is not None:
            polys[BIAS_POLY_ID] = Q.to_field(self.bias)
        if polys:
            aux.model_polys[node_id] = polys
        return MatMulCtx(
            node_id=node_id,
            left_const_shape=None if self.left_const is None else tuple(self.left_const.shape),
            right_const_shape=None if self.right_const is None else tuple(self.right_const.shape),
            with_bias=self.bias is not None,
        )

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        pt = last_claims[0].point
        comms = prover.ctx.commitment_ctx.model_comms.get(node_id, {})
        a, b = self._operands(step_data.inputs)
        (m, k), (k2, n) = a.shape, b.shape
        log_n, log_m = ceil_log2(n), ceil_log2(m)
        log_k = ceil_log2(max(k, k2))
        assert pt.shape[0] == log_n + log_m
        r_col, r_row = pt[:log_n], pt[log_n:]

        bias_eval = None
        if self.bias is not None:
            bias_eval = mle_mod.evaluate(comms[BIAS_POLY_ID][1], r_col)
        a_f = comms[LEFT_POLY_ID][1] if self.left_const is not None else Q.to_field(pad_matrix_pow2(a).reshape(-1))
        b_f = comms[RIGHT_POLY_ID][1] if self.right_const is not None else Q.to_field(pad_matrix_pow2(b).reshape(-1))

        vp = VirtualPolynomial.new(log_k)
        i_a = vp.add_mle(mle_mod.fix_high_variables(a_f, r_row))  # over the k variables
        i_b = vp.add_mle(mle_mod.fix_low_variables(b_f, r_col))
        vp.add_product((1, 0), [i_a, i_b])
        out = prove_device(vp, prover.dt)

        k_pt = out.proof.point
        a_claim = glue.DevClaim(point=glue.concat_points([k_pt, r_row]), eval=glue.at(out.final_evals, 0))
        b_claim = glue.DevClaim(point=glue.concat_points([r_col, k_pt]), eval=glue.at(out.final_evals, 1))
        common, next_claims = {}, []
        for const, pid, claim in ((self.left_const, LEFT_POLY_ID, a_claim), (self.right_const, RIGHT_POLY_ID, b_claim)):
            if const is not None:
                common[pid] = claim
            else:
                next_claims.append(claim)
        if self.bias is not None:
            common[BIAS_POLY_ID] = glue.DevClaim(point=r_col, eval=bias_eval)
        if common:
            prover.commit_prover.add_common_claims(node_id, common)
        prover.push_proof(
            node_id,
            MatMulProof(sumcheck=out.proof, individual_claims=out.final_evals, dims=(log_m, log_k, log_n),
                        bias_eval=bias_eval),
        )
        return next_claims


@dataclasses.dataclass
class MatMulProof:
    sumcheck: object
    individual_claims: object
    dims: tuple  # (log_m, log_k, log_n)
    bias_eval: object = None


@dataclasses.dataclass
class MatMulCtx:
    node_id: int
    left_const_shape: tuple | None = None
    right_const_shape: tuple | None = None
    with_bias: bool = False

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: MatMulProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        log_m, log_k, log_n = proof.dims
        claimed = last_claim.eval
        if self.with_bias:
            claimed = host.ext_sub(claimed, proof.bias_eval)
        sub = sumcheck_verify(claimed, proof.sumcheck.round_messages, log_k, 2, verifier.transcript)
        got = host.ext_mul(proof.individual_claims[0], proof.individual_claims[1])
        assert got == sub.expected_evaluation, "matmul sumcheck final mismatch"
        k_pt = list(sub.point)
        r_col, r_row = list(last_claim.point[:log_n]), list(last_claim.point[log_n:])
        a_claim = Claim(point=k_pt + r_row, eval=proof.individual_claims[0])
        b_claim = Claim(point=r_col + k_pt, eval=proof.individual_claims[1])
        common, next_claims = {}, []
        for shape, pid, claim in ((self.left_const_shape, LEFT_POLY_ID, a_claim),
                                  (self.right_const_shape, RIGHT_POLY_ID, b_claim)):
            if shape is not None:
                common[pid] = claim
            else:
                next_claims.append(claim)
        if self.with_bias:
            common[BIAS_POLY_ID] = Claim(point=r_col, eval=proof.bias_eval)
        if common:
            verifier.commit_verifier.add_common_claims(self.node_id, common)
        return next_claims
