"""LayerNorm with the InverseSQRT lookup, as in the JAX package's
`zkml/layers/layernorm.py`.

Quantized semantics, per row of the last dimension (N the unpadded width,
m = round(2^24 S_in^2)):
    S      = sum_c x[c]
    full   = m (N sum_c x^2 - S^2)        (>= 0; an int64, never a float)
    range  = full mod 2^rc                (range-checked in BIT_LEN chunks)
    inv_in = full >> rc
    v      = InverseSQRT_table(inv_in)    (output scale 2^10)
    out[c] = gamma[c] (N x[c] - S) v + beta[c]

Proof:
  1. lookups: (inv_in, inv_out) in the InverseSQRT table, the range chunks
     in Range (the top chunk scaled by 2^tcs to fill BIT_LEN bits);
  2. the io sumcheck (degree 4) at the output claim rho:
     sum eq (N gamma_rep X V_rep - gamma_rep S_rep V_rep + beta_rep);
  3. the linking sumcheck (degree 3) at u_r:
     sum_j w_j chunk_j~(u_r) + 2^rc inv_in~(u_r)
       = sum eq_rep (m N X^2 - m 2^-k S_rep^2);
  4. the four X claims merged into one producer claim (same-poly), the
     row sums through S~(q) = 2^k X~(1/2 .. 1/2, q).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import device as device_mod
from ... import glue
from ...fields import gf, host
from ...fields.gf import GF2
from ...lookup.logup import Claim
from ...poly import mle as mle_mod
from ...sumcheck import VirtualPolynomial, prove_device
from ...sumcheck import verify as sumcheck_verify
from .. import quantization as Q
from ..commit import same_poly_prove_device, same_poly_verify
from ..lookup_context import (
    COLUMN_SEPARATOR,
    LAYERNORM_OUTPUT_SCALE_FACTOR,
    LAYERNORM_SCALE_FACTOR,
    LogUpWitness,
    TableType,
    inv_sqrt_rows,
)
from ..tensor import Tensor, ceil_log2, next_pow2, pad_vec_pow2

GAMMA_POLY_ID = "LayerNormGamma"
BETA_POLY_ID = "LayerNormBeta"
P = host.P


def _repeat_ext_rows(arr: GF2, reps: int) -> GF2:
    """Each element `reps` times in a row (a row's value over its columns)."""
    return GF2(arr.a0.repeat_interleave(reps), arr.a1.repeat_interleave(reps))


def _const_ext(values, device) -> GF2:
    """Base constants as a GF2 made on `device` (no copy from the host)."""
    return GF2(torch.stack([gf.full((), v, device) for v in values]), gf.zeros((len(values),), device))


@dataclasses.dataclass
class LayerNorm:
    """Quantized LayerNorm: gamma and beta int64 tensors (padded to a power
    of two), dim_size the unpadded width N."""

    gamma: torch.Tensor
    beta: torch.Tensor
    dim_size: int
    multiplier: int  # m = round(2^24 S_in^2)
    eps: float  # N^2 times the float epsilon
    range_check_bits: int
    shared_logup = True  # its lookups go into the consolidated logup proofs

    def __post_init__(self):
        self.gamma = pad_vec_pow2(self.gamma.to(torch.int64))
        b = torch.zeros_like(self.gamma)
        b[: self.beta.numel()] = self.beta.reshape(-1).to(device=b.device, dtype=torch.int64)
        self.beta = b
        rem = self.range_check_bits % Q.BIT_LEN
        self.top_chunk_scalar_log = (Q.BIT_LEN - rem) if rem else 0
        self.n_chunks = (self.range_check_bits - 1) // Q.BIT_LEN + 1
        # the InverseSQRT table's output column, built once on the layer's device
        self._inv_out = torch.from_numpy(inv_sqrt_rows(self.table_type.params)[1]).to(self.gamma.device)

    @staticmethod
    def from_float(gamma_f, beta_f, eps: float, s_in: float, s_gamma: float | None = None,
                   device="cuda") -> "LayerNorm":
        """Quantize float gamma, beta (host numpy, as the JAX package does)
        into a layer on `device`."""
        dev = device_mod.resolve(device)
        gamma_f = np.asarray(gamma_f, dtype=np.float64)
        beta_f = np.asarray(beta_f, dtype=np.float64)
        n = gamma_f.size
        if s_gamma is None:
            s_gamma = max(1e-12, float(np.abs(gamma_f).max())) / Q.MAX
        multiplier = int(round(LAYERNORM_SCALE_FACTOR * s_in * s_in))
        full_bits = 2 * (ceil_log2(n) + Q.BIT_LEN - 1) + ceil_log2(max(2, multiplier)) + 1
        gamma_q = np.clip(np.round(gamma_f / s_gamma), Q.MIN, Q.MAX).astype(np.int64)
        s_beta = s_in * s_gamma / LAYERNORM_OUTPUT_SCALE_FACTOR
        beta_q = np.round(beta_f / s_beta).astype(np.int64)
        return LayerNorm(
            gamma=torch.from_numpy(gamma_q).to(dev), beta=torch.from_numpy(beta_q).to(dev), dim_size=n,
            multiplier=multiplier, eps=float(n * n * eps), range_check_bits=full_bits - 2 * (Q.BIT_LEN - 1),
        )

    @property
    def is_provable(self) -> bool:
        return True

    @property
    def table_type(self) -> TableType:
        return TableType.inv_sqrt(self.eps, self.range_check_bits)

    def _rows(self, x: torch.Tensor):
        """Per-row witness (S, full, range, inv_in, inv_out) of the padded
        input (R, C), in int64."""
        s = x.sum(dim=1)
        full = self.multiplier * (self.dim_size * (x * x).sum(dim=1) - s * s)
        rng = full & ((1 << self.range_check_bits) - 1)
        inv_in = full >> self.range_check_bits
        inv_out = self._inv_out[inv_in + (1 << (2 * (Q.BIT_LEN - 1)))]  # rows start at -2^(2(B-1))
        return s, full, rng, inv_in, inv_out

    def _pad_input(self, x: torch.Tensor) -> torch.Tensor:
        r, c = x.shape
        out = torch.zeros((next_pow2(r), self.gamma.numel()), dtype=torch.int64, device=x.device)
        out[:r, :c] = x
        return out

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = self._pad_input(inputs[0].data.to(torch.int64))
        s, _, _, _, inv_out = self._rows(x)
        out = self.gamma[None, :] * (self.dim_size * x - s[:, None]) * inv_out[:, None] + self.beta[None, :]
        return [Tensor(out)]

    def output_bitsize(self) -> int:
        return ceil_log2(self.dim_size) + 2 * (Q.BIT_LEN - 1) + ceil_log2(LAYERNORM_OUTPUT_SCALE_FACTOR) + 3

    def step_info(self, node_id: int, aux):
        aux.tables.add(TableType("range"))
        aux.tables.add(self.table_type)
        aux.model_polys[node_id] = {BETA_POLY_ID: Q.to_field(self.beta), GAMMA_POLY_ID: Q.to_field(self.gamma)}
        return LayerNormCtx(
            node_id=node_id, dim_size=self.dim_size, multiplier=self.multiplier, eps=self.eps,
            range_check_bits=self.range_check_bits, log_c=ceil_log2(self.gamma.numel()),
            n_chunks=self.n_chunks, top_chunk_scalar_log=self.top_chunk_scalar_log,
        )

    def shared_lookup_layout(self):
        return [(1, 2, self.table_type), (self.n_chunks, 1, TableType("range"))]

    def gen_lookup_witness(self, node_id, ctx, step_data):
        x = self._pad_input(step_data.inputs[0].data.to(torch.int64))
        _, _, rng, inv_in, inv_out = self._rows(x)
        chunks = []
        for j in range(self.n_chunks):
            c = (rng >> (j * Q.BIT_LEN)) & ((1 << Q.BIT_LEN) - 1)
            if j == self.n_chunks - 1 and self.top_chunk_scalar_log:
                c = c * (1 << self.top_chunk_scalar_log)
            chunks.append(c)
        inv_looked_up = inv_in + inv_out * COLUMN_SEPARATOR
        range_looked_up = torch.cat(chunks)
        inv_cols = [Q.to_field(inv_in), Q.to_field(inv_out)]
        chunk_cols = [Q.to_field(c) for c in chunks]
        wits = [
            LogUpWitness(polys=inv_cols, column_evals=inv_cols, columns_per_instance=2, table_type=self.table_type),
            LogUpWitness(polys=chunk_cols, column_evals=chunk_cols, columns_per_instance=1,
                         table_type=TableType("range")),
        ]
        return wits, {self.table_type: inv_looked_up, TableType("range"): range_looked_up}

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        dt = prover.dt
        rho = last_claims[0].point
        dev = rho.device
        x = self._pad_input(step_data.inputs[0].data.to(torch.int64))
        r_rows, c_cols = x.shape
        k, log_r = ceil_log2(c_cols), ceil_log2(r_rows)
        assert rho.shape[0] == k + log_r

        inv_wit, range_wit = prover.lookup_witnesses_for(node_id)
        # the lookup columns' claims at the consolidated proofs' points
        for comm_poly, cl in zip(inv_wit.commits, prover.shared_claims_for(node_id, 0)):
            prover.commit_prover.add_witness_claim(comm_poly, cl)
        for comm_poly, cl in zip(range_wit.commits, prover.shared_claims_for(node_id, 1)):
            prover.commit_prover.add_witness_claim(comm_poly, cl)

        s, _, _, _, inv_out = self._rows(x)
        x_f = Q.to_field(x.reshape(-1))  # columns low, rows high
        s_rep = Q.to_field(s.repeat_interleave(c_cols))

        # --- the io sumcheck at rho -------------------------------------
        vp = VirtualPolynomial.new(k + log_r)
        i_eq = vp.add_mle(mle_mod.eq_table(rho))
        i_g = vp.add_mle(Q.to_field(self.gamma.repeat(r_rows)))
        i_x = vp.add_mle(x_f)
        i_v = vp.add_mle(Q.to_field(inv_out.repeat_interleave(c_cols)))
        i_s = vp.add_mle(s_rep)
        i_b = vp.add_mle(Q.to_field(self.beta.repeat(r_rows)))
        vp.add_product((self.dim_size % P, 0), [i_eq, i_g, i_x, i_v])
        vp.add_product((P - 1, 0), [i_eq, i_g, i_s, i_v])
        vp.add_product((1, 0), [i_eq, i_b])
        io_out = prove_device(vp, dt)
        u = io_out.proof.point
        u_c, u_r = u[:k], u[k:]
        f = io_out.final_evals  # [eq, gamma_rep, X, V_rep, S_rep, beta_rep]
        prover.commit_prover.add_common_claims(
            node_id,
            {GAMMA_POLY_ID: glue.DevClaim(point=u_c, eval=f[1]), BETA_POLY_ID: glue.DevClaim(point=u_c, eval=f[5])},
        )
        # V_rep~(u) = inv_out~(u_r): another claim on the committed column
        prover.commit_prover.add_witness_claim(inv_wit.commits[1], glue.DevClaim(point=u_r, eval=f[3]))

        # --- the linking sumcheck at u_r --------------------------------
        inv_in_ur = mle_mod.evaluate(inv_wit.column_evals[0], u_r)
        chunk_urs = [mle_mod.evaluate(c, u_r) for c in range_wit.column_evals]
        prover.commit_prover.add_witness_claim(inv_wit.commits[0], glue.DevClaim(point=u_r, eval=inv_in_ur))
        for comm_poly, ev in zip(range_wit.commits, chunk_urs):
            prover.commit_prover.add_witness_claim(comm_poly, glue.DevClaim(point=u_r, eval=ev))
        provided = gf.ext_stack([inv_in_ur] + chunk_urs)
        dt.append_exts(provided)

        vp2 = VirtualPolynomial.new(k + log_r)
        j_eq = vp2.add_mle(_repeat_ext_rows(mle_mod.eq_table(u_r), c_cols))
        j_x = vp2.add_mle(x_f)
        j_s = vp2.add_mle(s_rep)
        inv2k = pow((1 << k) % P, P - 2, P)
        m_inv2k = (self.multiplier % P) * inv2k % P
        vp2.add_product(((self.multiplier * self.dim_size) % P, 0), [j_eq, j_x, j_x])
        vp2.add_product((P - m_inv2k, 0), [j_eq, j_s, j_s])
        link_out = prove_device(vp2, dt)
        w = link_out.proof.point
        w_r = w[k:]
        lf = link_out.final_evals  # [eq_rep, X, S_rep]

        # --- the X claims merged into one producer claim ----------------
        half_vec = _const_ext([(P + 1) // 2] * k, dev)
        inv2k_dev = _const_ext([inv2k], dev).reshape(())
        x_claims = [
            glue.DevClaim(point=u, eval=f[2]),
            glue.DevClaim(point=glue.concat_points([half_vec, u_r]), eval=gf.ext_mul(f[4], inv2k_dev)),
            glue.DevClaim(point=w, eval=lf[1]),
            glue.DevClaim(point=glue.concat_points([half_vec, w_r]), eval=gf.ext_mul(lf[2], inv2k_dev)),
        ]
        merge_proof = same_poly_prove_device(x_f, x_claims, dt)
        prover.push_proof(
            node_id,
            LayerNormProof(
                io_sumcheck=io_out.proof, io_evals=f, link_sumcheck=link_out.proof, link_evals=lf,
                provided_evals=provided, x_merge=merge_proof,
                commitments=[c[0].commitment for c in inv_wit.commits + range_wit.commits],
            ),
        )
        return [merge_proof.extract_claim()]


@dataclasses.dataclass
class LayerNormProof:
    io_sumcheck: object
    io_evals: object
    link_sumcheck: object
    link_evals: object
    provided_evals: object  # [inv_in at u_r, chunk_j at u_r ...]
    x_merge: object  # SamePolyProof
    commitments: list  # inv_in, inv_out, then the chunks


@dataclasses.dataclass
class LayerNormCtx:
    node_id: int
    dim_size: int
    multiplier: int
    eps: float
    range_check_bits: int
    log_c: int
    n_chunks: int
    top_chunk_scalar_log: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: LayerNormProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        k = self.log_c
        log_r = len(last_claim.point) - k
        for cm, cl in zip(proof.commitments[:2], verifier.shared_logup_claims[(self.node_id, 0)]):
            verifier.commit_verifier.add_witness_claim(cm, cl)
        for cm, cl in zip(proof.commitments[2:], verifier.shared_logup_claims[(self.node_id, 1)]):
            verifier.commit_verifier.add_witness_claim(cm, cl)

        # --- the io sumcheck ---------------------------------------------
        sub = sumcheck_verify(last_claim.eval, proof.io_sumcheck.round_messages, k + log_r, 4, verifier.transcript)
        u = list(sub.point)
        u_c, u_r = u[:k], u[k:]
        f = proof.io_evals
        n_f = (self.dim_size % P, 0)
        got = host.ext_mul(
            host.ext_eq_eval(list(last_claim.point), u),
            host.ext_add(
                host.ext_sub(
                    host.ext_mul(host.ext_mul(n_f, host.ext_mul(f[1], f[2])), f[3]),
                    host.ext_mul(host.ext_mul(f[1], f[4]), f[3]),
                ),
                f[5],
            ),
        )
        assert got == sub.expected_evaluation, "layernorm io sumcheck mismatch"
        verifier.commit_verifier.add_common_claims(
            self.node_id, {GAMMA_POLY_ID: Claim(point=list(u_c), eval=f[1]), BETA_POLY_ID: Claim(point=list(u_c), eval=f[5])},
        )
        verifier.commit_verifier.add_witness_claim(proof.commitments[1], Claim(point=list(u_r), eval=f[3]))

        # --- the linking sumcheck ----------------------------------------
        provided = proof.provided_evals
        inv_in_ur, chunk_urs = provided[0], provided[1:]
        assert len(chunk_urs) == self.n_chunks
        verifier.commit_verifier.add_witness_claim(proof.commitments[0], Claim(point=list(u_r), eval=inv_in_ur))
        for cm, ev in zip(proof.commitments[2:], chunk_urs):
            verifier.commit_verifier.add_witness_claim(cm, Claim(point=list(u_r), eval=ev))
        verifier.transcript.append_field_element_exts(provided)
        # the claimed sum: sum_j w_j chunk_j + 2^rc inv_in at u_r
        rhs = host.ext_mul(((1 << self.range_check_bits) % P, 0), inv_in_ur)
        for j, ev in enumerate(chunk_urs):
            wbits = j * Q.BIT_LEN
            if j == self.n_chunks - 1 and self.top_chunk_scalar_log:
                wbits -= self.top_chunk_scalar_log
            rhs = host.ext_add(rhs, host.ext_mul((pow(2, wbits, P), 0), ev))
        sub2 = sumcheck_verify(rhs, proof.link_sumcheck.round_messages, k + log_r, 3, verifier.transcript)
        w = list(sub2.point)
        w_r = w[k:]
        lf = proof.link_evals
        eq_rep_eval = host.ext_eq_eval(u_r, w_r)
        inv2k = pow((1 << k) % P, P - 2, P)
        m_n = ((self.multiplier * self.dim_size) % P, 0)
        m_inv2k = ((self.multiplier % P) * inv2k % P, 0)
        got2 = host.ext_mul(
            eq_rep_eval,
            host.ext_sub(host.ext_mul(m_n, host.ext_mul(lf[1], lf[1])), host.ext_mul(m_inv2k, host.ext_mul(lf[2], lf[2]))),
        )
        assert got2 == sub2.expected_evaluation, "layernorm link sumcheck mismatch"
        assert lf[0] == eq_rep_eval, "layernorm eq_rep claim mismatch"

        # --- the X claims merged -----------------------------------------
        half = [((P + 1) // 2, 0)] * k
        x_claims = [
            Claim(point=u, eval=f[2]),
            Claim(point=half + u_r, eval=host.ext_mul(f[4], (inv2k, 0))),
            Claim(point=w, eval=lf[1]),
            Claim(point=half + w_r, eval=host.ext_mul(lf[2], (inv2k, 0))),
        ]
        return [same_poly_verify(proof.x_merge, x_claims, k + log_r, verifier.transcript)]
