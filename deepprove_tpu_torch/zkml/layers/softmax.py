"""Quantized Softmax with exp lookups, the error-table normalization and the
causal mask's sumcheck, as in the JAX package's `zkml/layers/softmax.py`
(the zkLLM scheme).

Inputs are rescaled to the fixed-point scale 2^24 (scalar =
round(2^24 S_in)), shifted per row by the negated log-sum-exp (so each row
of exp outputs sums to about 2^12, the quantised one), then causal-masked
to neg_inf = -((bkm >> 16) + 1) << 16. Each value v (at most 0) splits as
    |v| = low + 2^8 high + 2^16 exp_in + sum_j 2^(16 + sts + j ztv) zin_j
with low, high in the Range table, (exp_in, exp_out) in the Softmax exp
table (output scale 2^12, rows from bkm on map to 0) and (zin_j, zout_j) in
the Zero table (zout = 1 iff zin = 0). The output is exp_out prod_j
zout_j. Row sums of the output are looked up in the error table, the
normalization check that binds the committed shift to the log-sum-exp.

Proof: the lookups (exp, range, error, zero) go into the consolidated
logup proofs. Sumcheck A, at a batching challenge a:
    a O~(rho) + a^2 rowsum~(p_err)
      = sum_x (a eq_rho + a^2 2^k eq_{(1/2)^k, p_err}) exp_out prod zout
binds the exp_out and zout claims at u (rowsum~(q) = 2^k O~((1/2)^k, q), so
the row sums need no commitment). Sumcheck B proves at u
    sum_x eq_u tril (scalar X + shift_rep)
      = -bias~(u) - low~(u) - 2^8 high~(u) - 2^16 exp_in~(u) - sum_j w_j zin_j~(u)
with the columns' evaluations at u opened as commitment claims, tril and
bias public, and the final evaluations giving the producer's claim on X
and the committed shift's claim.

The witness's shift is computed on the host in float32 numpy, row by row,
as the JAX package computes it (a rounding difference would change the
witness); the decomposition runs in torch on the model's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import glue
from ...fields import gf, host
from ...lookup import logup
from ...lookup.logup import Claim
from ...poly import mle as mle_mod
from ...sumcheck import VirtualPolynomial, prove_device
from ...sumcheck import verify as sumcheck_verify
from .. import quantization as Q
from ..lookup_context import (
    COLUMN_SEPARATOR,
    LOG_SCALE_FACTOR,
    OUTPUT_SCALE_FACTOR,
    SCALE_FACTOR,
    LogUpWitness,
    TableType,
    softmax_rows,
)
from ..tensor import Tensor, ceil_log2


def calc_softmax_error(bl: int, max_context: float, output_sf: float, input_sf: float,
                       temp: float) -> tuple[float, float]:
    """The zkLLM error bound and the cutoff bkm."""
    kml = 1.0
    bkm_multiplier = kml * np.log(2.0 * max_context) + np.log(output_sf)
    bkm = input_sf * temp * bkm_multiplier / (kml + 1.0)
    common = kml * input_sf * temp
    first = np.exp(bl / common)
    second = np.exp(bkm / common) / (2.0 * output_sf ** (1.0 / kml))
    c = (first + second) ** kml - 1.0
    term1 = c * np.exp(1.0 / (2.0 * input_sf * temp))
    term2 = (max_context - 1.0) * np.exp(-bkm / input_sf * temp)
    return float(abs(term1 + term2)), float(bkm)


def tril_mask(seq, r: int, c: int, device="cpu") -> torch.Tensor:
    """0/1 (r, c) mask: 1 iff col <= row mod seq (all 1 without a mask)."""
    if seq is None:
        return torch.ones((r, c), dtype=torch.int64, device=device)
    ri = torch.arange(r, device=device) % seq
    return (torch.arange(c, device=device)[None, :] <= ri[:, None]).to(torch.int64)


@dataclasses.dataclass
class Softmax:
    """Causal-masked quantized softmax over the last dim; seq the rows per
    channel for the mask (None: no mask); domain_max bounds |input|."""

    s_in: float
    max_size: int = 1024
    temperature: float = 1.0
    seq: int | None = None
    domain_max: int = Q.MAX

    def __post_init__(self):
        inv_t = 1.0 / self.temperature
        self.scalar = int(round(SCALE_FACTOR * self.s_in))
        max_shift = int(round(-SCALE_FACTOR * (inv_t * np.log(self.max_size) + self.s_in * self.domain_max)))
        min_input = -int(self.domain_max) * self.scalar + max_shift
        min_input_bits = ceil_log2(abs(min_input >> 16))
        err, bkm_f = calc_softmax_error(1 << (LOG_SCALE_FACTOR - 8), float(self.max_size),
                                        float(OUTPUT_SCALE_FACTOR), float(SCALE_FACTOR), inv_t)
        self.error_bound = err
        self.bkm = int(round(bkm_f))
        self.sts = ceil_log2(self.bkm >> 16)  # the exp table's bits
        if min_input_bits > self.sts:
            remaining = min_input_bits - self.sts
            self.n_zero_chunks = (remaining - 1) // self.sts + 1
            self.ztv = remaining if self.n_zero_chunks == 1 else self.sts
        else:
            self.n_zero_chunks, self.ztv = 0, 0
        self.neg_inf = -(((self.bkm >> 16) + 1) << 16)
        self.inv_temp = inv_t

    @property
    def exp_table(self) -> TableType:
        return TableType.softmax(self.inv_temp, self.sts, self.bkm)

    @property
    def error_table(self) -> TableType:
        return TableType.error(OUTPUT_SCALE_FACTOR, max(1, int(round(self.error_bound * OUTPUT_SCALE_FACTOR))))

    @property
    def zero_table(self) -> TableType | None:
        return TableType("zero", (self.ztv,)) if self.n_zero_chunks else None

    @property
    def is_provable(self) -> bool:
        return True

    def _shift(self, x: np.ndarray) -> np.ndarray:
        """Each row's negated log-sum-exp at scale 2^24, in float32 numpy."""
        tril = tril_mask(self.seq, *x.shape).numpy().astype(bool)
        shifts = np.zeros(x.shape[0], dtype=np.int64)
        for i in range(x.shape[0]):
            active = x[i][tril[i]]
            mx = np.int64(active.max())
            s = np.sum(np.exp((active - mx).astype(np.float32) * np.float32(self.s_in / self.inv_temp)),
                       dtype=np.float32)
            lse = np.log(s, dtype=np.float32)
            shifts[i] = -np.int64(round(float(SCALE_FACTOR * self.inv_temp * lse))) - mx * np.int64(self.scalar)
        return shifts

    def _witness(self, x: torch.Tensor) -> dict:
        x = x.to(torch.int64)
        x = x.reshape(-1, x.shape[-1])  # (channels rows, cols)
        r, c = x.shape
        assert r & (r - 1) == 0 and c & (c - 1) == 0, "padded pow2 input"
        dev = x.device
        shift = torch.from_numpy(self._shift(x.cpu().numpy())).to(dev)
        tril = tril_mask(self.seq, r, c, dev)
        shifted = x * self.scalar + shift[:, None]
        masked = shifted * tril + self.neg_inf * (1 - tril)
        a = -masked
        low, high = a & 255, (a >> 8) & 255
        exp_in = (a >> 16) & ((1 << self.sts) - 1)
        a = a >> (16 + self.sts)
        exp_out = torch.from_numpy(softmax_rows(self.exp_table.params)[1]).to(dev)[exp_in]
        out = exp_out
        zins, zouts = [], []
        for _ in range(self.n_zero_chunks):
            zin = a & ((1 << self.ztv) - 1)
            zout = (zin == 0).to(torch.int64)
            out = out * zout
            zins.append(zin)
            zouts.append(zout)
            a = a >> self.ztv
        if bool(((masked > 0) | (a != 0)).any()):
            raise AssertionError("softmax inputs must be <= 0 after the shift and within the decomposition")
        return dict(shift=shift, tril=tril, low=low, high=high, exp_in=exp_in, exp_out=exp_out, zins=zins,
                    zouts=zouts, out=out)

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        return [Tensor(self._witness(inputs[0].data)["out"].reshape(inputs[0].data.shape))]

    def step_info(self, node_id: int, aux):
        aux.tables.add(TableType("range"))
        aux.tables.add(self.exp_table)
        aux.tables.add(self.error_table)
        if self.zero_table is not None:
            aux.tables.add(self.zero_table)
        return SoftmaxCtx(node_id=node_id, scalar=self.scalar, sts=self.sts, ztv=self.ztv,
                          n_zero_chunks=self.n_zero_chunks, neg_inf=self.neg_inf, seq=self.seq,
                          exp_table_params=self.exp_table.params, error_table_params=self.error_table.params)

    shared_logup = True  # its lookups go into the consolidated logup proofs

    def shared_lookup_layout(self):
        out = [(1, 2, self.exp_table), (2, 1, TableType("range")), (1, 1, self.error_table)]
        if self.n_zero_chunks:
            out.append((self.n_zero_chunks, 2, self.zero_table))
        return out

    def gen_lookup_witness(self, node_id, ctx, step_data):
        w = self._witness(step_data.inputs[0].data)

        def col(v):
            return Q.to_field(v.reshape(-1))

        rowsums = w["out"].sum(dim=1)
        exp_cols, range_cols = [col(w["exp_in"]), col(w["exp_out"])], [col(w["low"]), col(w["high"])]
        wits = [
            LogUpWitness(polys=exp_cols, column_evals=exp_cols, columns_per_instance=2, table_type=self.exp_table),
            LogUpWitness(polys=range_cols, column_evals=range_cols, columns_per_instance=1,
                         table_type=TableType("range")),
            LogUpWitness(polys=[col(w["shift"])], column_evals=[col(rowsums)], columns_per_instance=1,
                         table_type=self.error_table),
        ]
        looked_up = {
            self.exp_table: (w["exp_in"] + w["exp_out"] * COLUMN_SEPARATOR).reshape(-1),
            TableType("range"): torch.cat([w["low"].reshape(-1), w["high"].reshape(-1)]),
            self.error_table: rowsums,
        }
        if self.n_zero_chunks:
            zero_cols = [col(v) for zin, zout in zip(w["zins"], w["zouts"]) for v in (zin, zout)]
            wits.append(LogUpWitness(polys=zero_cols, column_evals=zero_cols, columns_per_instance=2,
                                     table_type=self.zero_table))
            looked_up[self.zero_table] = torch.cat(
                [(zin + zout * COLUMN_SEPARATOR).reshape(-1) for zin, zout in zip(w["zins"], w["zouts"])])
        return wits, looked_up

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        dt, p = prover.dt, host.P
        last_claim = last_claims[0]
        x = step_data.inputs[0].data.to(torch.int64)
        x = x.reshape(-1, x.shape[-1])
        r_rows, c_cols = x.shape
        k = ceil_log2(c_cols)
        n = k + ceil_log2(r_rows)
        assert last_claim.point.shape[0] == n
        dev = x.device

        wits = prover.lookup_witnesses_for(node_id)
        exp_wit, range_wit, err_wit = wits[:3]
        zero_wit = wits[3] if self.n_zero_chunks else None
        exp_claims = prover.shared_claims_for(node_id, 0)  # [in, out]
        range_claims = prover.shared_claims_for(node_id, 1)  # [low, high]
        err_claim = prover.shared_claims_for(node_id, 2)[0]  # rowsum~ at the shared point
        zero_claims = prover.shared_claims_for(node_id, 3) if zero_wit is not None else []
        # bind the looked-up columns to their commitments at the shared points
        for wit, claims in ((exp_wit, exp_claims), (range_wit, range_claims), (zero_wit, zero_claims)):
            for comm_poly, cl in zip(wit.commits if wit is not None else [], claims):
                prover.commit_prover.add_witness_claim(comm_poly, cl)

        # sumcheck A: output and row sums at the batching challenge
        alpha = dt.get_and_append_challenge(b"softmax_batching")
        half = ((p + 1) // 2) % p
        full_err_point = glue.concat_points([gf.ext_from_pairs([(half, 0)] * k, dev), err_claim.point])
        zouts = [zero_wit.column_evals[2 * j + 1] for j in range(self.n_zero_chunks)]
        vp = VirtualPolynomial.new(n)
        i_rho = vp.add_mle(mle_mod.eq_table(last_claim.point))
        i_err = vp.add_mle(mle_mod.eq_table(full_err_point))
        i_out = vp.add_mle(exp_wit.column_evals[1])
        i_z = [vp.add_mle(c) for c in zouts]
        vp.add_product((1, 0), [i_rho, i_out] + i_z)
        vp.add_product((1, 0), [i_err, i_out] + i_z)
        vp.coeffs_dev = gf.ext_stack(
            [alpha, gf.ext_mul_base(gf.ext_mul(alpha, alpha), gf.full((), (1 << k) % p, dev))])
        a_out = prove_device(vp, dt)
        u, af = a_out.proof.point, a_out.final_evals  # af: [eq_rho, eq_err, exp_out, zout...]
        prover.commit_prover.add_witness_claim(exp_wit.commits[1], glue.DevClaim(point=u, eval=glue.at(af, 2)))
        for j in range(self.n_zero_chunks):
            prover.commit_prover.add_witness_claim(zero_wit.commits[2 * j + 1],
                                                   glue.DevClaim(point=u, eval=glue.at(af, 3 + j)))

        # the provided column evaluations at u
        cols_at_u = [exp_wit.column_evals[0], range_wit.column_evals[0], range_wit.column_evals[1]]
        comm_list = [exp_wit.commits[0], range_wit.commits[0], range_wit.commits[1]]
        for j in range(self.n_zero_chunks):
            cols_at_u.append(zero_wit.column_evals[2 * j])
            comm_list.append(zero_wit.commits[2 * j])
        ev_at_u = logup._batch_evaluate(torch.stack(cols_at_u), u)
        for i, comm_poly in enumerate(comm_list):
            prover.commit_prover.add_witness_claim(comm_poly, glue.DevClaim(point=u, eval=glue.at(ev_at_u, i)))
        dt.append_exts(ev_at_u)

        # sumcheck B: the mask and the decomposition at u
        w = self._witness(x)
        vp2 = VirtualPolynomial.new(n)
        j_eq = vp2.add_mle(mle_mod.eq_table(u))
        j_t = vp2.add_mle(Q.to_field(w["tril"].reshape(-1)))
        j_x = vp2.add_mle(Q.to_field(x.reshape(-1)))
        j_s = vp2.add_mle(Q.to_field(w["shift"].repeat_interleave(c_cols)))
        vp2.add_product((self.scalar % p, 0), [j_eq, j_t, j_x])
        vp2.add_product((1, 0), [j_eq, j_t, j_s])
        b_out = prove_device(vp2, dt)
        v, bf = b_out.proof.point, b_out.final_evals  # bf: [eq_u, tril, X, shift_rep]
        prover.commit_prover.add_witness_claim(err_wit.commits[0], glue.DevClaim(point=v[k:], eval=glue.at(bf, 3)))

        prover.push_proof(
            node_id,
            SoftmaxProof(
                a_sumcheck=a_out.proof, a_evals=af, provided_evals=ev_at_u, b_sumcheck=b_out.proof, b_evals=bf,
                commitments={
                    "exp": [c[0].commitment for c in exp_wit.commits],
                    "range": [c[0].commitment for c in range_wit.commits],
                    "shift": err_wit.commits[0][0].commitment,
                    "zero": [c[0].commitment for c in zero_wit.commits] if zero_wit is not None else [],
                },
            ),
        )
        return [glue.DevClaim(point=v, eval=glue.at(bf, 2))]


@dataclasses.dataclass
class SoftmaxProof:
    a_sumcheck: object
    a_evals: object
    provided_evals: object
    b_sumcheck: object
    b_evals: object
    commitments: dict


@dataclasses.dataclass
class SoftmaxCtx:
    node_id: int
    scalar: int
    sts: int
    ztv: int
    n_zero_chunks: int
    neg_inf: int
    seq: int | None
    exp_table_params: tuple
    error_table_params: tuple

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: SoftmaxProof, last_claims, verifier) -> list[Claim]:
        p, t, cv = host.P, verifier.transcript, verifier.commit_verifier
        last_claim = last_claims[0]
        n = len(last_claim.point)
        shared = verifier.shared_logup_claims
        exp_claims, range_claims, err_claims = (shared[(self.node_id, i)] for i in range(3))
        zero_claims = shared[(self.node_id, 3)] if self.n_zero_chunks else []
        for cms, claims in ((proof.commitments["exp"], exp_claims), (proof.commitments["range"], range_claims),
                            (proof.commitments["zero"], zero_claims)):
            for cm, cl in zip(cms, claims):
                cv.add_witness_claim(cm, cl)

        # sumcheck A
        alpha = t.get_and_append_challenge(b"softmax_batching")
        err_claim = err_claims[0]
        k = n - len(err_claim.point)
        half = ((p + 1) // 2) % p
        full_err_point = [(half, 0)] * k + list(err_claim.point)
        a2 = host.ext_mul(alpha, alpha)
        claimed = host.ext_add(host.ext_mul(alpha, last_claim.eval), host.ext_mul(a2, err_claim.eval))
        sub = sumcheck_verify(claimed, proof.a_sumcheck.round_messages, n, 2 + self.n_zero_chunks, t)
        u = list(sub.point)
        af = proof.a_evals
        prod = af[2]
        for j in range(self.n_zero_chunks):
            prod = host.ext_mul(prod, af[3 + j])
        eq_rho, eq_err = host.ext_eq_eval(last_claim.point, u), host.ext_eq_eval(full_err_point, u)
        got = host.ext_add(host.ext_mul(host.ext_mul(alpha, eq_rho), prod),
                           host.ext_mul(host.ext_mul(a2, host.ext_mul(((1 << k) % p, 0), eq_err)), prod))
        assert got == sub.expected_evaluation, "softmax A sumcheck mismatch"
        cv.add_witness_claim(proof.commitments["exp"][1], Claim(point=u, eval=af[2]))
        for j in range(self.n_zero_chunks):
            cv.add_witness_claim(proof.commitments["zero"][2 * j + 1], Claim(point=u, eval=af[3 + j]))

        # the provided evaluations at u
        prov = proof.provided_evals
        comm_list = [proof.commitments["exp"][0], proof.commitments["range"][0], proof.commitments["range"][1]]
        comm_list += [proof.commitments["zero"][2 * j] for j in range(self.n_zero_chunks)]
        for cm, ev in zip(comm_list, prov):
            cv.add_witness_claim(cm, Claim(point=u, eval=ev))
        t.append_field_element_exts(prov)

        # sumcheck B: bias~(u) = neg_inf (1 - tril~(u)), tril in closed form
        tril_u = tril_eval(self.seq, k, n, u)
        rhs = host.ext_mul((self.neg_inf % p, 0), host.ext_sub((1, 0), tril_u))
        rhs = host.ext_add(rhs, prov[1])
        rhs = host.ext_add(rhs, host.ext_mul((1 << 8, 0), prov[2]))
        rhs = host.ext_add(rhs, host.ext_mul((1 << 16, 0), prov[0]))
        for j in range(self.n_zero_chunks):
            rhs = host.ext_add(rhs, host.ext_mul((pow(2, 16 + self.sts + j * self.ztv, p), 0), prov[3 + j]))
        sub2 = sumcheck_verify(host.ext_sub((0, 0), rhs), proof.b_sumcheck.round_messages, n, 3, t)
        v = list(sub2.point)
        bf = proof.b_evals
        tril_v = tril_eval(self.seq, k, n, v)
        got2 = host.ext_mul(host.ext_eq_eval(u, v),
                            host.ext_mul(tril_v, host.ext_add(host.ext_mul((self.scalar % p, 0), bf[2]), bf[3])))
        assert got2 == sub2.expected_evaluation, "softmax B sumcheck mismatch"
        assert bf[1] == tril_v, "softmax tril claim mismatch"
        cv.add_witness_claim(proof.commitments["shift"], Claim(point=v[k:], eval=bf[3]))
        return [Claim(point=v, eval=bf[2])]


def tril_eval(seq, k: int, n: int, point) -> tuple:
    """tril~(point) in O(log N): for the square per-channel block (2^k =
    seq) the mask's MLE factors bitwise into a <= fold over the column bits
    point[:k] and the row-within-channel bits point[k:2k] (the channel bits
    drop out); other blocks evaluate the mask directly."""
    if seq is None:
        return (1, 0)
    ls = (seq - 1).bit_length() if seq > 1 else 0
    if (1 << ls) != seq or ls != k or n < 2 * k:
        return host.mle_eval_v(gf.to_u64(Q.to_field(tril_mask(seq, 1 << (n - k), 1 << k).reshape(-1))), point)
    one, acc = (1, 0), (1, 0)
    for c, r in zip(point[:k], point[k : 2 * k]):
        cr = host.ext_mul(c, r)
        eq_bit = host.ext_add(host.ext_sub(host.ext_sub(one, c), r), host.ext_add(cr, cr))
        lt_bit = host.ext_mul(host.ext_sub(one, c), r)
        acc = host.ext_add(host.ext_mul(acc, eq_bit), lt_bit)
    return acc
