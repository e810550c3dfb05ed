"""Maxpool2D (kernel 2, stride 2), as in the JAX package's
`zkml/layers/pooling.py`.

The four per-position diffs output - input[2i + b, 2j + a] are (a)
range-checked through the consolidated logup proofs (max implies every
diff >= 0 and < 2^BIT_LEN) and (b) zero-checked: sum_x eq(x) prod_k
diff_k(x) = 0 (some diff is 0, so the max is attained), batched with the
diff and output claim-tying terms into one degree-5 sumcheck whose
products take the coefficients 1, bc, ..., bc^5. The previous layer's
claim substitutes a fresh challenge for the two kernel-parity bits: point
= [r1] ++ zc[:gap] ++ [r1] ++ zc[gap:], gap = log W - 1 for the padded
input width W. The JAX package uses the one challenge r1 for both parity
bits, and the port does the same. The JAX verifier takes the gap from the
proof; the port's layer knows its input shape, so its verifier derives the
gap and rejects a proof that names another.
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
from ..lookup_context import LogUpWitness, TableType
from ..tensor import Tensor, ceil_log2, next_pow2

ExtPair = tuple[int, int]


def _pad3(x: torch.Tensor) -> torch.Tensor:
    c, h, w = x.shape
    out = torch.zeros((next_pow2(c), next_pow2(h), next_pow2(w)), dtype=torch.int64, device=x.device)
    out[:c, :h, :w] = x
    return out


def parity_multiplicands(r1: ExtPair, r2: ExtPair) -> list[ExtPair]:
    """eq of the two parity bits at (r1, r2), in diff order k = 2a + b."""
    omr1, omr2 = host.ext_sub((1, 0), r1), host.ext_sub((1, 0), r2)
    return [host.ext_mul(omr1, omr2), host.ext_mul(omr1, r2), host.ext_mul(r1, omr2), host.ext_mul(r1, r2)]


def parity_multiplicands_device(r1: GF2, r2: GF2) -> GF2:
    """`parity_multiplicands` of two device GF2 () challenges, as GF2 (4,)."""
    one = gf.ext_ones((), r1.device)
    omr1, omr2 = gf.ext_sub(one, r1), gf.ext_sub(one, r2)
    return gf.ext_stack([gf.ext_mul(omr1, omr2), gf.ext_mul(omr1, r2), gf.ext_mul(r1, omr2), gf.ext_mul(r1, r2)])


def variable_gap(width: int) -> int:
    """Where the column parity bit sits in the input claim's point: after
    the log W - 1 output-column variables of the padded width W."""
    return ceil_log2(next_pow2(width)) - 1


@dataclasses.dataclass
class Maxpool2D:
    input_shape: tuple  # (c, h, w) of the tensor it pools
    shared_logup = True  # its lookups go into the consolidated logup proofs

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = inputs[0].data
        assert tuple(x.shape) == tuple(self.input_shape), f"maxpool input {tuple(x.shape)} != {self.input_shape}"
        c, h, w = x.shape
        return [Tensor(x.reshape(c, h // 2, 2, w // 2, 2).amax(dim=(2, 4)))]

    def shared_lookup_layout(self):
        return [(4, 1, TableType("range"))]

    def step_info(self, node_id: int, aux):
        aux.tables.add(TableType("range"))
        return PoolingCtx(node_id=node_id, gap=variable_gap(self.input_shape[2]))

    @staticmethod
    def diffs(inp: torch.Tensor, out: torch.Tensor) -> list[torch.Tensor]:
        """columns[k] = O - I[row parity k & 1, col parity k >> 1], flat in O's layout."""
        ip, op = _pad3(inp), _pad3(out)
        return [(op - ip[:, k & 1 :: 2, k >> 1 :: 2]).reshape(-1) for k in range(4)]

    def gen_lookup_witness(self, node_id, ctx, step_data):
        out = step_data.outputs[0].data
        cols = self.diffs(step_data.inputs[0].data, out)
        looked_up = torch.cat(cols)
        col_fields = [Q.to_field(c) for c in cols]
        out_field = Q.to_field(_pad3(out).reshape(-1))
        wit = LogUpWitness(
            polys=col_fields + [out_field], column_evals=col_fields, columns_per_instance=1,
            table_type=TableType("range"),
        )
        return [wit], {TableType("range"): looked_up}

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        dt = prover.dt
        last_claim = last_claims[0]
        (wit,) = prover.lookup_witnesses_for(node_id)
        lk_claims = prover.shared_claims_for(node_id, 0)  # 4, at one point
        num_vars = wit.column_evals[0].shape[0].bit_length() - 1
        bc = dt.get_and_append_challenge(b"batch_pooling")

        # MLE order [diff_0..diff_3, beta, out, last_beta]
        vp = VirtualPolynomial.new(num_vars)
        i_d = vp.add_mle_rows(torch.stack(wit.column_evals))
        i_beta = vp.add_mle(mle_mod.eq_table(lk_claims[0].point))
        i_out = vp.add_mle(wit.commits[4][1])
        i_lb = vp.add_mle(mle_mod.eq_table(last_claim.point))
        diffs = [i_d + k for k in range(4)]
        vp.add_product(None, diffs + [i_beta])  # the zerocheck, degree 5
        for d in diffs:
            vp.add_product(None, [d, i_beta])
        vp.add_product(None, [i_out, i_lb])
        vp.coeffs_dev = gf.ext_powers(bc, len(vp.products))  # 1, bc, ..., bc^5

        out = prove_device(vp, dt)
        zc_point = out.proof.point
        zerocheck_evals = glue.take(out.final_evals, diffs + [i_out])
        commitments = []
        for i, (comm, poly) in enumerate(wit.commits):
            prover.commit_prover.add_witness_claim(
                (comm, poly), glue.DevClaim(point=zc_point, eval=zerocheck_evals[i])
            )
            commitments.append(comm.commitment)

        # the input claim, with a fresh challenge for both parity bits
        r1 = dt.get_and_append_challenge(b"input_batching")
        mults = parity_multiplicands_device(r1, r1)
        diff_evals, output_eval = zerocheck_evals[:4], zerocheck_evals[4]
        in_eval = gf.ext_sum_axis(gf.ext_mul(mults, gf.ext_sub(output_eval, diff_evals)), 0)
        gap = variable_gap(self.input_shape[2])
        r1 = r1.reshape(1)
        point = gf.ext_concatenate([r1, zc_point[:gap], r1, zc_point[gap:]])
        prover.push_proof(
            node_id,
            PoolingProof(
                sumcheck=out.proof, zerocheck_evals=zerocheck_evals, variable_gap=gap, commitments=commitments,
            ),
        )
        return [glue.DevClaim(point=point, eval=in_eval)]


@dataclasses.dataclass
class PoolingProof:
    sumcheck: object
    zerocheck_evals: object  # [diff_0..diff_3, output]
    variable_gap: int
    commitments: list


@dataclasses.dataclass
class PoolingCtx:
    node_id: int
    gap: int  # `variable_gap` of the input width

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: PoolingProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        lk_claims = verifier.shared_logup_claims[(self.node_id, 0)]
        tr = verifier.transcript
        bc = tr.get_and_append_challenge(b"batch_pooling")
        powers = host.ext_powers(bc, 6)
        initial = (0, 0)
        for cl, c in zip(lk_claims, powers[1:5]):
            initial = host.ext_add(initial, host.ext_mul(cl.eval, c))
        initial = host.ext_add(initial, host.ext_mul(powers[5], last_claim.eval))

        sub = sumcheck_verify(initial, proof.sumcheck.round_messages, len(lk_claims[0].point), 5, tr)
        zc_point = sub.point
        beta = host.ext_eq_eval(lk_claims[0].point, zc_point)
        last_beta = host.ext_eq_eval(last_claim.point, zc_point)
        prod, s = beta, (0, 0)
        for ev, c in zip(proof.zerocheck_evals[:4], powers[1:5]):
            prod = host.ext_mul(prod, ev)
            s = host.ext_add(s, host.ext_mul(c, ev))
        output_eval = proof.zerocheck_evals[4]
        expected = host.ext_add(
            host.ext_add(prod, host.ext_mul(s, beta)),
            host.ext_mul(host.ext_mul(output_eval, last_beta), powers[5]),
        )
        assert expected == sub.expected_evaluation, "pooling zerocheck mismatch"
        assert len(proof.commitments) == 5, "pooling commitment count"
        for ev, commit in zip(proof.zerocheck_evals, proof.commitments):
            verifier.commit_verifier.add_witness_claim(commit, Claim(point=list(zc_point), eval=ev))

        r1 = tr.get_and_append_challenge(b"input_batching")
        r2 = r1
        in_eval = (0, 0)
        for m, ev in zip(parity_multiplicands(r1, r2), proof.zerocheck_evals[:4]):
            in_eval = host.ext_add(in_eval, host.ext_mul(m, host.ext_sub(output_eval, ev)))
        assert proof.variable_gap == self.gap, "pooling variable gap"
        gap = self.gap
        return [Claim(point=[r1] + list(zc_point[:gap]) + [r2] + list(zc_point[gap:]), eval=in_eval)]
