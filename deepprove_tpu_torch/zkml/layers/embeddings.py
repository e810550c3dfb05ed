"""Embeddings and Positional layers, as in the JAX package's
`zkml/layers/embeddings.py`.

Embeddings: out[t, :] = E[token_t, :], proven as the matmul S E, where S
is the public one-hot token-selection matrix. The tokens are a model input,
so the verifier evaluates S's MLE itself:
S~(s_v, r_t) = sum_t eq(r_t, t) eq(s_v, bits(token_t)).

Positional: out = in + P with a committed positional matrix P; the claim
splits in closed form, in~(r) = out~(r) - P~(r).
"""

from __future__ import annotations

import dataclasses

import torch

from ... import glue
from ...fields import gf, host
from ...fields.gf import GF2
from ...lookup.logup import Claim
from ...poly import mle as mle_mod
from ...sumcheck import VirtualPolynomial, prove_device
from ...sumcheck import verify as sumcheck_verify
from .. import quantization as Q
from ..tensor import Tensor, ceil_log2, pad_matrix_pow2

EMB_POLY_ID = "embedding"
POS_POLY_ID = "positional"


@dataclasses.dataclass
class Positional:
    """out = in + P; P a committed (T, D) int64 tensor."""

    table: torch.Tensor

    def __post_init__(self):
        self.table = pad_matrix_pow2(self.table.to(torch.int64))

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = inputs[0].data
        return [Tensor(x + self.table[: x.shape[0]])]

    def step_info(self, node_id: int, aux):
        aux.model_polys[node_id] = {POS_POLY_ID: Q.to_field(self.table.reshape(-1))}
        return PositionalCtx(node_id=node_id)

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        pt = last_claims[0].point
        p_eval = mle_mod.evaluate(prover.ctx.commitment_ctx.model_comms[node_id][POS_POLY_ID][1], pt)
        prover.commit_prover.add_common_claims(node_id, {POS_POLY_ID: glue.DevClaim(point=pt, eval=p_eval)})
        prover.push_proof(node_id, PositionalProof(p_eval=p_eval))
        return [glue.DevClaim(point=pt, eval=gf.ext_sub(last_claims[0].eval, p_eval))]


@dataclasses.dataclass
class PositionalProof:
    p_eval: object


@dataclasses.dataclass
class PositionalCtx:
    node_id: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: PositionalProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        verifier.commit_verifier.add_common_claims(
            self.node_id, {POS_POLY_ID: Claim(point=list(last_claim.point), eval=proof.p_eval)}
        )
        return [Claim(point=list(last_claim.point), eval=host.ext_sub(last_claim.eval, proof.p_eval))]


def scatter_tokens(eq_t: GF2, tokens: torch.Tensor, v: int) -> GF2:
    """out[w] = sum over t with tokens[t] = w of eq_t[t], in the field: the
    32-bit halves of every limb summed by an integer scatter-add (no sum
    reaches 2^63), then folded back mod p."""

    def limb(a):
        lo, hi = gf.split_halves(a[: tokens.numel()])
        zeros = torch.zeros(v, dtype=torch.int64, device=a.device)
        return gf.from_halves(zeros.index_add(0, tokens, hi), zeros.index_add(0, tokens, lo))

    return GF2(limb(eq_t.a0), limb(eq_t.a1))


@dataclasses.dataclass
class Embeddings:
    """out[t] = E[token_t]; the tokens are a public model input."""

    table: torch.Tensor  # (V, D) int64

    def __post_init__(self):
        self.table = pad_matrix_pow2(self.table.to(torch.int64))

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(self.table[inputs[0].data.reshape(-1)])]

    def step_info(self, node_id: int, aux):
        aux.model_polys[node_id] = {EMB_POLY_ID: Q.to_field(self.table.reshape(-1))}
        return EmbeddingsCtx(node_id=node_id, log_v=ceil_log2(self.table.shape[0]),
                             log_d=ceil_log2(self.table.shape[1]))

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        pt = last_claims[0].point
        tokens = step_data.inputs[0].data.reshape(-1).to(torch.int64)
        v, d = self.table.shape
        log_d, log_v = ceil_log2(d), ceil_log2(v)
        assert pt.shape[0] == log_d + Tensor(tokens).num_vars()
        r_d, r_t = pt[:log_d], pt[log_d:]

        s_fixed = scatter_tokens(mle_mod.eq_table(r_t), tokens, v)  # S(., r_t)
        e_fixed = mle_mod.fix_low_variables(prover.ctx.commitment_ctx.model_comms[node_id][EMB_POLY_ID][1], r_d)
        vp = VirtualPolynomial.new(log_v)
        vp.add_product((1, 0), [vp.add_mle(s_fixed), vp.add_mle(e_fixed)])
        out = prove_device(vp, prover.dt)
        prover.commit_prover.add_common_claims(
            node_id,
            {EMB_POLY_ID: glue.DevClaim(point=glue.concat_points([r_d, out.proof.point]),
                                        eval=glue.at(out.final_evals, 1))},
        )
        prover.push_proof(node_id, EmbeddingsProof(sumcheck=out.proof, individual_claims=out.final_evals))
        # the tokens are a model input: the verifier checks this claim itself
        return [glue.DevClaim(point=r_t, eval=mle_mod.evaluate(Tensor(tokens).to_field(), r_t))]


@dataclasses.dataclass
class EmbeddingsProof:
    sumcheck: object
    individual_claims: object


def selection_eval(tokens: list[int], r_t, s_v) -> tuple[int, int]:
    """sum_t eq(r_t, t) eq(s_v, bits(token_t)) on the host."""
    acc = (0, 0)
    for t, tok in enumerate(tokens):
        term = (1, 0)
        for bits, point in ((t, r_t), (tok, s_v)):
            for b, r in enumerate(point):
                term = host.ext_mul(term, r if (bits >> b) & 1 else host.ext_sub((1, 0), r))
        acc = host.ext_add(acc, term)
    return acc


@dataclasses.dataclass
class EmbeddingsCtx:
    node_id: int
    log_v: int
    log_d: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: EmbeddingsProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        r_d, r_t = list(last_claim.point[: self.log_d]), list(last_claim.point[self.log_d :])
        sub = sumcheck_verify(last_claim.eval, proof.sumcheck.round_messages, self.log_v, 2, verifier.transcript)
        s_v = list(sub.point)
        got = host.ext_mul(proof.individual_claims[0], proof.individual_claims[1])
        assert got == sub.expected_evaluation, "embeddings sumcheck mismatch"
        tokens = verifier.public_inputs_for(self.node_id)
        assert selection_eval(tokens.tolist(), r_t, s_v) == proof.individual_claims[0], "one-hot selection mismatch"
        verifier.commit_verifier.add_common_claims(
            self.node_id, {EMB_POLY_ID: Claim(point=r_d + s_v, eval=proof.individual_claims[1])}
        )
        return [Claim(point=r_t, eval=host.mle_eval_v(gf.to_u64(Tensor(tokens).to_field()), r_t))]
