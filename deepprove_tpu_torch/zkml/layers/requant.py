"""Requantization layer, as in the JAX package's `zkml/layers/requant.py`.

tmp = in * fpm + 2^(shift - 1); the top part (tmp >> shift) goes through the
Clamping table, and the low `shift` bits split into BIT_LEN-bit chunks that
are range-checked in the Range table. One sumcheck ties the incoming claim
to the clamping output column and brings every lookup column's claim to
one point; the layer's input claim is recombined as
fpm^-1 (clamp_in 2^shift + sum_j chunk_j 2^(j BIT_LEN) - 2^(shift - 1)).
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
from ..lookup_context import COLUMN_SEPARATOR, LogUpWitness, TableType
from ..quantization import RequantSpec
from ..tensor import Tensor, next_pow2

ExtPair = tuple[int, int]


@dataclasses.dataclass
class Requant:
    spec: RequantSpec
    shared_logup = True  # its lookups go into the consolidated logup proofs

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(self.spec.apply(inputs[0].data))]

    def _clamp_table(self) -> TableType:
        return TableType("clamping", (self.spec.clamping_size(),))

    def step_info(self, node_id: int, aux):
        aux.tables.add(TableType("range"))
        aux.tables.add(self._clamp_table())
        return RequantCtx(spec=self.spec, node_id=node_id)

    def gen_lookup_witness(self, node_id, ctx, step_data):
        spec = self.spec
        inp = step_data.inputs[0].flat()
        v = torch.zeros(next_pow2(inp.numel()), dtype=torch.int64, device=inp.device)
        v[: inp.numel()] = inp
        shift = spec.shift
        tmp = v * spec.fixed_point_multiplier + (1 << (shift - 1))
        clamp_in = tmp >> shift
        masked = tmp & ((1 << shift) - 1)
        clamp_out = clamp_in.clamp(Q.MIN, Q.MAX)
        range_mask = (1 << Q.BIT_LEN) - 1
        chunks = [(masked >> (j * Q.BIT_LEN)) & range_mask for j in range(shift // Q.BIT_LEN)]

        range_looked_up = torch.cat(chunks)
        clamp_looked_up = clamp_in + clamp_out * COLUMN_SEPARATOR
        clamp_cols = [Q.to_field(clamp_in), Q.to_field(clamp_out)]
        chunk_cols = [Q.to_field(c) for c in chunks]
        wits = [
            LogUpWitness(
                polys=clamp_cols, column_evals=clamp_cols,
                columns_per_instance=2, table_type=self._clamp_table(),
            ),
            LogUpWitness(
                polys=chunk_cols, column_evals=chunk_cols,
                columns_per_instance=1, table_type=TableType("range"),
            ),
        ]
        return wits, {TableType("range"): range_looked_up, self._clamp_table(): clamp_looked_up}

    def shared_lookup_layout(self):
        """(instances, columns per instance, table) per witness: what the
        verifier expects of the consolidated lookup proofs."""
        return [(1, 2, self._clamp_table()), (self.spec.shift // Q.BIT_LEN, 1, TableType("range"))]

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        dt = prover.dt
        last_claim = last_claims[0]
        clamping_wit, shifted_wit = prover.lookup_witnesses_for(node_id)
        clamping_claims = prover.shared_claims_for(node_id, 0)
        shifted_claims = prover.shared_claims_for(node_id, 1)
        bc = dt.get_and_append_challenge(b"requant_batching")

        clamp_cols = clamping_wit.column_evals  # [in, out]
        chunk_cols = shifted_wit.column_evals
        num_vars = clamp_cols[0].shape[0].bit_length() - 1

        # MLE order [clamp_out, last_beta, clamping_beta, clamp_in,
        # shifted_beta, chunk_0, chunk_1, ...], as the reference stores them
        vp = VirtualPolynomial.new(num_vars)
        i_out = vp.add_mle(clamp_cols[1])
        i_lb = vp.add_mle(mle_mod.eq_table(last_claim.point))
        i_cb = vp.add_mle(mle_mod.eq_table(clamping_claims[0].point))
        i_in = vp.add_mle(clamp_cols[0])
        i_sb = vp.add_mle(mle_mod.eq_table(shifted_claims[0].point))
        i_chunk = vp.add_mle_rows(torch.stack(chunk_cols))
        vp.add_product(None, [i_out, i_lb])
        vp.add_product(None, [i_out, i_cb])
        vp.add_product(None, [i_in, i_cb])
        for j in range(len(chunk_cols)):
            vp.add_product(None, [i_sb, i_chunk + j])
        vp.coeffs_dev = gf.ext_powers(bc, len(vp.products))  # 1, bc, bc^2, ...

        out = prove_device(vp, dt)
        point = out.proof.point
        chunk_idx = [i_chunk + j for j in range(len(chunk_cols))]
        # [clamp_in, clamp_out, chunk_0, ...]: the commitments' order
        accumulation_evals = glue.take(out.final_evals, [i_in, i_out] + chunk_idx)
        weights, offset = _recombine_weights(self.spec, len(chunk_cols))
        recombined = gf.ext_mul_base(glue.take(out.final_evals, [i_in] + chunk_idx),
                                     gf.from_u64(weights, point.device))
        combined = gf.ext_sub(gf.ext_sum_axis(recombined, 0), gf.ext_scalar((offset, 0), point.device))

        commitments = []
        for i, (comm, poly) in enumerate(clamping_wit.commits + shifted_wit.commits):
            prover.commit_prover.add_witness_claim(
                (comm, poly), glue.DevClaim(point=point, eval=accumulation_evals[i])
            )
            commitments.append(comm.commitment)
        prover.push_proof(
            node_id,
            RequantProof(io_accumulation=out.proof, accumulation_evals=accumulation_evals,
                         commitments=commitments),
        )
        return [glue.DevClaim(point=point, eval=combined)]


def _recombine_weights(spec: RequantSpec, k: int):
    """The input claim as sum_j w_j e_j - offset over [clamp_in, chunk_0, ...]:
    w = fpm^-1 [2^shift, 2^0, 2^BIT_LEN, ...], offset = fpm^-1 2^(shift - 1)."""
    p = host.P
    fpm_inv = pow(spec.fixed_point_multiplier % p, p - 2, p)
    weights = [(1 << spec.shift) % p] + [pow(1 << Q.BIT_LEN, j, p) for j in range(k)]
    return [w * fpm_inv % p for w in weights], (1 << (spec.shift - 1)) % p * fpm_inv % p


def recombine_claims(spec: RequantSpec, clamp_in_eval, shifted_evals) -> ExtPair:
    weights, offset = _recombine_weights(spec, len(shifted_evals))
    acc = (0, 0)
    for w, e in zip(weights, [clamp_in_eval] + list(shifted_evals)):
        acc = host.ext_add(acc, host.ext_mul((w, 0), e))
    return host.ext_sub(acc, (offset, 0))


@dataclasses.dataclass
class RequantProof:
    io_accumulation: object  # SumcheckProof
    accumulation_evals: object  # [clamp_in, clamp_out, chunk_0, ...]
    commitments: list


@dataclasses.dataclass
class RequantCtx:
    spec: RequantSpec
    node_id: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: RequantProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        clamping_claims = verifier.shared_logup_claims[(self.node_id, 0)]
        shifted_claims = verifier.shared_logup_claims[(self.node_id, 1)]
        bc = verifier.transcript.get_and_append_challenge(b"requant_batching")

        clamping_point = clamping_claims[0].point
        shifted_point = shifted_claims[0].point
        values = [last_claim.eval, clamping_claims[1].eval, clamping_claims[0].eval]
        values += [c.eval for c in shifted_claims]
        initial_eval = (0, 0)
        for chal, v in zip(host.ext_powers(bc, len(values)), values):
            initial_eval = host.ext_add(initial_eval, host.ext_mul(chal, v))

        num_vars = len(clamping_point)
        sub = sumcheck_verify(
            initial_eval, proof.io_accumulation.round_messages, num_vars, 2, verifier.transcript
        )
        acc_point = sub.point
        last_beta = host.ext_eq_eval(last_claim.point, acc_point)
        clamping_beta = host.ext_eq_eval(clamping_point, acc_point)
        shifted_beta = host.ext_eq_eval(shifted_point, acc_point)

        ae = proof.accumulation_evals
        calc = host.ext_mul(host.ext_add(last_beta, host.ext_mul(bc, clamping_beta)), ae[1])
        combiner = host.ext_mul(bc, bc)
        calc = host.ext_add(calc, host.ext_mul(host.ext_mul(combiner, clamping_beta), ae[0]))
        for v in ae[2:]:
            combiner = host.ext_mul(combiner, bc)
            calc = host.ext_add(calc, host.ext_mul(host.ext_mul(v, shifted_beta), combiner))
        assert calc == sub.expected_evaluation, "requant accumulation mismatch"

        next_eval = recombine_claims(self.spec, ae[0], ae[2:])
        assert len(proof.commitments) == len(ae), "requant commitment count"
        for commit, ev in zip(proof.commitments, ae):
            verifier.commit_verifier.add_witness_claim(commit, Claim(point=list(acc_point), eval=ev))
        return [Claim(point=list(acc_point), eval=next_eval)]
