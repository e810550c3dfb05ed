"""The fused QKV projection, as in the JAX package's `zkml/layers/qkv.py`.

The three attention projections Q = X W_q + b_q, K = X W_k + b_k,
V = X W_v + b_v are one layer. The three output claims (r_i, y_i), one per
output wire, reduce after their bias evaluations are subtracted to one
degree-2 sumcheck over the shared contracted axis k:

    sum_i l^i (y_i - b_i~(r_col_i)) = sum_k sum_i l^i X(r_row_i, k) W_i(k, r_col_i)

three products with coefficients 1, l, l^2 (l a Fiat-Shamir challenge).
The three claims on X share the sumcheck point k_pt in their low (column)
variables, so a same-poly sumcheck over g(rows) = X(k_pt, rows) merges
them into the one input claim.

The builder (`llm._embed_head_cols`) embeds each head's weight columns in
an (h_pad, d_pad) power-of-two layout with zero weights and biases in the
pad lanes, so pad outputs are exactly zero.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import glue
from ...fields import gf, host
from ...lookup.logup import Claim
from ...poly import mle as mle_mod
from ...sumcheck import VirtualPolynomial, prove_device
from ...sumcheck import verify as sumcheck_verify
from .. import quantization as Q
from ..commit import same_poly_prove_device, same_poly_verify
from ..tensor import Tensor, ceil_log2, next_pow2, pad_matrix_pow2
from .matmul import int_matmul

NAMES = ("q", "k", "v")


@dataclasses.dataclass
class QKV:
    """Three constant projections of one input, proven with one sumcheck:
    ws[i] an int64 (k, n) weight (padded to powers of two), bs[i] an (n,)
    bias. Output wires [X W_q + b_q, X W_k + b_k, X W_v + b_v]."""

    ws: list
    bs: list

    def __post_init__(self):
        assert len(self.ws) == 3 and len(self.bs) == 3
        self.ws = [pad_matrix_pow2(w.to(torch.int64)) for w in self.ws]
        assert len({tuple(w.shape) for w in self.ws}) == 1, "q/k/v weights must share a shape"
        n = self.ws[0].shape[1]
        bs = []
        for b in self.bs:
            bb = torch.zeros(n, dtype=torch.int64, device=b.device)
            bb[: b.numel()] = b.reshape(-1)
            bs.append(bb)
        self.bs = bs

    @property
    def is_provable(self) -> bool:
        return True

    def _padded_input(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.int64)
        x = x.reshape(x.shape[0], -1) if x.dim() > 1 else x.reshape(1, -1)
        xp = torch.zeros((next_pow2(x.shape[0]), self.ws[0].shape[0]), dtype=torch.int64, device=x.device)
        xp[: x.shape[0], : x.shape[1]] = x
        return xp

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        xp = self._padded_input(inputs[0].data)
        return [Tensor(int_matmul(xp, w) + b[None, :]) for w, b in zip(self.ws, self.bs)]

    def output_bitsize(self) -> int:
        return 2 * (Q.BIT_LEN - 1) + ceil_log2(max(2, self.ws[0].shape[0])) + 1

    def step_info(self, node_id: int, aux):
        polys = {}
        for name, w, b in zip(NAMES, self.ws, self.bs):
            polys[f"b_{name}"] = Q.to_field(b)
            polys[f"w_{name}"] = Q.to_field(w.reshape(-1))
        aux.model_polys[node_id] = polys
        k, n = self.ws[0].shape
        return QKVCtx(node_id=node_id, log_k=ceil_log2(k), log_n=ceil_log2(n))

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        assert len(last_claims) == 3, "QKV expects one claim per projection"
        comms = prover.ctx.commitment_ctx.model_comms[node_id]
        xp = self._padded_input(step_data.inputs[0].data)
        (m, k), n = xp.shape, self.ws[0].shape[1]
        log_m, log_k, log_n = ceil_log2(m), ceil_log2(k), ceil_log2(n)
        x_f = Q.to_field(xp.reshape(-1))

        # the batching challenge, after the downstream claims fixed the transcript
        lam = prover.dt.read_challenges(1)[0]
        vp = VirtualPolynomial.new(log_k)
        r_cols, r_rows, bias_evals = [], [], []
        for name, claim in zip(NAMES, last_claims):
            pt = claim.point
            assert pt.shape[0] == log_n + log_m
            r_col, r_row = pt[:log_n], pt[log_n:]
            r_cols.append(r_col)
            r_rows.append(r_row)
            bias_evals.append(mle_mod.evaluate(comms[f"b_{name}"][1], r_col))
            ix = vp.add_mle(mle_mod.fix_high_variables(x_f, r_row))
            iw = vp.add_mle(mle_mod.fix_low_variables(comms[f"w_{name}"][1], r_col))
            vp.add_product((1, 0), [ix, iw])
        vp.coeffs_dev = gf.ext_powers(lam, 3)
        out = prove_device(vp, prover.dt)
        k_pt = out.proof.point

        common = {}
        for i, name in enumerate(NAMES):
            common[f"w_{name}"] = glue.DevClaim(point=glue.concat_points([r_cols[i], k_pt]),
                                                eval=glue.at(out.final_evals, 2 * i + 1))
            common[f"b_{name}"] = glue.DevClaim(point=r_cols[i], eval=bias_evals[i])
        prover.commit_prover.add_common_claims(node_id, common)

        # merge the three input claims over g(rows) = X(k_pt, rows)
        g = mle_mod.fix_low_variables(x_f, k_pt)
        x_claims = [glue.DevClaim(point=r_rows[i], eval=glue.at(out.final_evals, 2 * i)) for i in range(3)]
        sp = same_poly_prove_device(g, x_claims, prover.dt)
        merged = sp.extract_claim()
        prover.push_proof(
            node_id,
            QKVProof(sumcheck=out.proof, individual_claims=out.final_evals, bias_evals=gf.ext_stack(bias_evals),
                     same_poly=sp),
        )
        return [glue.DevClaim(point=glue.concat_points([k_pt, merged.point]), eval=merged.eval)]


@dataclasses.dataclass
class QKVProof:
    sumcheck: object
    individual_claims: object  # [x_q, w_q, x_k, w_k, x_v, w_v]
    bias_evals: object  # 3 bias evaluations
    same_poly: object


@dataclasses.dataclass
class QKVCtx:
    node_id: int
    log_k: int
    log_n: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: QKVProof, last_claims, verifier) -> list[Claim]:
        t = verifier.transcript
        assert len(last_claims) == 3
        log_n, log_k = self.log_n, self.log_k
        log_m = len(last_claims[0].point) - log_n
        lams = host.ext_powers(t.read_challenge(), 3)
        claimed = (0, 0)
        r_cols, r_rows = [], []
        for i in range(3):
            pt = list(last_claims[i].point)
            r_cols.append(pt[:log_n])
            r_rows.append(pt[log_n:])
            claimed = host.ext_add(claimed, host.ext_mul(lams[i], host.ext_sub(last_claims[i].eval, proof.bias_evals[i])))
        sub = sumcheck_verify(claimed, proof.sumcheck.round_messages, log_k, 2, t)
        f = proof.individual_claims
        got = (0, 0)
        for i in range(3):
            got = host.ext_add(got, host.ext_mul(lams[i], host.ext_mul(f[2 * i], f[2 * i + 1])))
        assert got == sub.expected_evaluation, "qkv sumcheck final mismatch"
        k_pt = list(sub.point)
        common = {}
        for i, name in enumerate(NAMES):
            common[f"w_{name}"] = Claim(point=r_cols[i] + k_pt, eval=f[2 * i + 1])
            common[f"b_{name}"] = Claim(point=r_cols[i], eval=proof.bias_evals[i])
        verifier.commit_verifier.add_common_claims(self.node_id, common)
        x_claims = [Claim(point=r_rows[i], eval=f[2 * i]) for i in range(3)]
        merged = same_poly_verify(proof.same_poly, x_claims, log_m, t)
        return [Claim(point=k_pt + list(merged.point), eval=merged.eval)]
