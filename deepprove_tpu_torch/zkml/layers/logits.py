"""Logits (argmax), as in the JAX package's `zkml/layers/logits.py`.

Each row of the (rows, vocab) logits matrix outputs its argmax index, the
public generated token. Soundness:
  * diff[i, j] = max[i] - X[i, j] is checked in the Range table (every
    entry at most the max; int8 logits make diff < 2^BIT_LEN);
  * a zerocheck at a fresh point q proves
        sum_x eq(q, x) one_hot(x) (max_rep(x) - X(x)) = 0
    with one_hot built from the public output tokens: the max is reached
    at the claimed argmax.
`max` is a committed witness column; the two claims on X (from the diff
and the zerocheck) merge into the producer's claim by same-poly. The
incoming output claim needs no binding: the output is public, and the
verifier reads it from `verifier.io.outputs`.
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
from ..lookup_context import LogUpWitness, TableType
from ..tensor import Tensor, ceil_log2
from .embeddings import selection_eval


@dataclasses.dataclass
class Logits:
    """Argmax over the last dim; one index a row."""

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(torch.argmax(inputs[0].data.to(torch.int64), dim=-1))]

    shared_logup = True  # the diff range check goes into the consolidated logup proofs

    def shared_lookup_layout(self):
        return [(1, 1, TableType("range"))]

    def step_info(self, node_id: int, aux):
        aux.tables.add(TableType("range"))
        return LogitsCtx(node_id=node_id)

    def gen_lookup_witness(self, node_id, ctx, step_data):
        x = step_data.inputs[0].data.to(torch.int64)
        mx = x.max(dim=-1).values
        diff = mx[:, None] - x
        diff_col, max_col = Q.to_field(diff.reshape(-1)), Q.to_field(mx)
        wit = LogUpWitness(polys=[diff_col, max_col], column_evals=[diff_col], columns_per_instance=1,
                           table_type=TableType("range"))
        # a diff outside the range table fails its lookup count
        return [wit], {TableType("range"): diff.reshape(-1)}

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        dt, p = prover.dt, host.P
        x = step_data.inputs[0].data.to(torch.int64)
        rows, vocab = x.shape
        k = ceil_log2(vocab)
        n = k + ceil_log2(rows)
        out_idx = step_data.outputs[0].data.reshape(-1)

        (wit,) = prover.lookup_witnesses_for(node_id)
        (diff_claim,) = prover.shared_claims_for(node_id, 0)  # diff~ (n variables)
        prover.commit_prover.add_witness_claim(wit.commits[0], diff_claim)
        pt = diff_claim.point
        pt_r = pt[k:]
        max_col = wit.commits[1][1]
        max_eval = mle_mod.evaluate(max_col, pt_r)
        prover.commit_prover.add_witness_claim(wit.commits[1], glue.DevClaim(point=pt_r, eval=max_eval))
        # X~(pt) = max_rep~(pt) - diff~(pt)
        x_claim_1 = glue.DevClaim(point=pt, eval=gf.ext_sub(max_eval, diff_claim.eval))

        # the zerocheck at a fresh point q
        q = dt.read_challenges(n)
        one_hot = torch.zeros((rows, vocab), dtype=torch.int64, device=x.device)
        one_hot[torch.arange(rows, device=x.device), out_idx] = 1
        row_max = x.gather(1, out_idx[:, None]).reshape(-1)
        vp = VirtualPolynomial.new(n)
        i_eq = vp.add_mle(mle_mod.eq_table(q))
        i_oh = vp.add_mle(one_hot.reshape(-1))
        i_m = vp.add_mle(Q.to_field(row_max.repeat_interleave(vocab)))
        x_f = Q.to_field(x.reshape(-1))
        i_x = vp.add_mle(x_f)
        vp.add_product((1, 0), [i_eq, i_oh, i_m])
        vp.add_product((p - 1, 0), [i_eq, i_oh, i_x])
        z_out = prove_device(vp, dt)
        v, zf = z_out.proof.point, z_out.final_evals  # zf: [eq, one_hot, max_rep, X]
        prover.commit_prover.add_witness_claim(wit.commits[1], glue.DevClaim(point=v[k:], eval=glue.at(zf, 2)))
        x_claim_2 = glue.DevClaim(point=v, eval=glue.at(zf, 3))

        merge = same_poly_prove_device(x_f, [x_claim_1, x_claim_2], dt)
        prover.push_proof(
            node_id,
            LogitsProof(max_eval=max_eval, zerocheck=z_out.proof, z_evals=zf, x_merge=merge,
                        commitments=[c[0].commitment for c in wit.commits], dims=(ceil_log2(rows), k)),
        )
        return [merge.extract_claim()]


@dataclasses.dataclass
class LogitsProof:
    max_eval: object
    zerocheck: object
    z_evals: object
    x_merge: object
    commitments: list
    dims: tuple


@dataclasses.dataclass
class LogitsCtx:
    node_id: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: LogitsProof, last_claims, verifier) -> list[Claim]:
        log_r, k = proof.dims
        n = log_r + k
        t, cv = verifier.transcript, verifier.commit_verifier
        (diff_claim,) = verifier.shared_logup_claims[(self.node_id, 0)]
        pt = list(diff_claim.point)
        cv.add_witness_claim(proof.commitments[0], diff_claim)
        cv.add_witness_claim(proof.commitments[1], Claim(point=pt[k:], eval=proof.max_eval))
        x_claim_1 = Claim(point=pt, eval=host.ext_sub(proof.max_eval, diff_claim.eval))

        q = [t.read_challenge() for _ in range(n)]
        sub = sumcheck_verify((0, 0), proof.zerocheck.round_messages, n, 3, t)
        v = list(sub.point)
        zf = proof.z_evals
        # the public MLEs at v: eq(q, v), and one_hot from the output tokens
        out_idx = verifier.io.outputs[verifier.ctx.model.output_nodes().index(self.node_id)].data
        # one_hot~(v) = sum_i eq(v_rows, i) eq(v_cols, token_i), O(rows n)
        tokens = out_idx.reshape(-1).cpu().tolist()[: 1 << log_r]
        oh_eval = selection_eval(tokens, v[k:], v[:k])
        assert zf[1] == oh_eval, "logits one-hot claim mismatch"
        got = host.ext_mul(host.ext_mul(host.ext_eq_eval(q, v), oh_eval), host.ext_sub(zf[2], zf[3]))
        assert got == sub.expected_evaluation, "logits zerocheck mismatch"
        cv.add_witness_claim(proof.commitments[1], Claim(point=v[k:], eval=zf[2]))
        return [same_poly_verify(proof.x_merge, [x_claim_1, Claim(point=v, eval=zf[3])], n, t)]
