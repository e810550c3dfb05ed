"""Convolution by frequency-domain sumchecks, as in the JAX package's
`zkml/layers/convolution.py` (zkCNN-style).

Semantics: per input channel j, x~_j = reverse(flatten(x_j)) zero-padded to
N = 2 n^2 and X_j = FFT(x~_j); per output channel i, prod_i = sum_j X_j o
W^_ij, c_i = iFFT(prod_i) and the output O[i, p] = c_i[n^2 - 1 - p] +
bias[i], with the cross-correlation wrap cleared by a public 0/1 mask. The
FFT is the Goldilocks NTT of `pcs/ntt.py`, and the weights are committed in
the frequency domain (the JAX package's documented deviation from the
reference), so the Merkle roots depend on its conventions bit for bit.

The proof is four chained sumchecks, claims flowing backwards:
  1. clearing: sum eq(., rho) mask B (degree 3; B the uncleared output);
  2. iFFT: c~(sigma) = sum_k phi_inv[k] prod~(k, rho_i) (degree 2);
  3. hadamard: prod~(s1, rho_i) = sum_{k,j,i} eq X(j, k) W^(i, j, k) (degree 3);
  4. FFT: X~(s2) = sum_t phi_fft[t] x~~(t, s2_j) (degree 2);
with closed-form point rewrites for the reversal, slice and zero padding.
The FFT-matrix rows factor as phi_r[k] = prod_b ((1 - r_b) + r_b w^(2^b k));
the verifier's phi~ evaluations are proven by the zkCNN delegation chain
(log N - 1 degree-3 sumchecks over the partial-product tables), leaving it
O(log^2 N) host work. A strided conv is proven as the full stride-1 conv
with the output claim's row and column points extended by zero variables.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ... import glue
from ...fields import gf, host
from ...fields.gf import GF2
from ...lookup.logup import Claim
from ...pcs import ntt
from ...poly import mle as mle_mod
from ...sumcheck import VirtualPolynomial, prove_device
from ...sumcheck import verify as sumcheck_verify
from .. import quantization as Q
from ..tensor import Tensor, ceil_log2, next_pow2

ExtPair = tuple[int, int]

WEIGHT_POLY_ID = "weight_freq"
BIAS_POLY_ID = "bias"


def _one_minus(p: ExtPair) -> ExtPair:
    return host.ext_sub((1, 0), p)


def _one_minus_dev(pt: GF2) -> GF2:
    return gf.ext_sub(gf.ext_ones(pt.shape, pt.device), pt)


def _pow2k(omega: int, k: int) -> int:
    """omega^(2^k) mod p."""
    return pow(omega % host.P, 1 << k, host.P)


def _powers(w: int, size: int, device) -> torch.Tensor:
    """[1, w, ..., w^(size-1)] on `device`, cached per device."""
    return ntt._on_device(
        ("powers", w, size), device, lambda: gf.from_u64(ntt.geom_powers(np.uint64(w), size), device)
    )


def _factor(r: GF2, w_b: int, size: int) -> GF2:
    """(1 - r) + r w_b^k for k in [0, size), r a device scalar."""
    pows = _powers(w_b, size, r.device)
    return gf.ext_add(_one_minus_dev(r), gf.ext_mul_base(r, pows))


# ---------------------------------------------------------------------------
# zkCNN FFT-matrix delegation. phi(k) = scale prod_{b<n} ((1 - r_b) + r_b
# w^(2^b k)); factor b has period 2^(n-b) in k, so the partial product over
# the factors b >= n-1-l is a table f_l of 2^(l+1) entries with f_l(k) =
# f_(l-1)(k mod 2^l) h_l(k), h_l(k) = (1 - r') + r' w'^k (r' = r_(n-1-l),
# w' = w^(2^(n-1-l))), whose MLE has a closed form. The verifier's O(N)
# phi-row evaluation becomes n - 1 degree-3 sumchecks of doubling sizes.
# ---------------------------------------------------------------------------


def phi_partials(pt: GF2, omega: int, n: int, scale: int) -> list:
    """All partial-product tables f_0 (2,) ... f_(n-1) (2^n,) = the phi row
    of the device point `pt` (n,)."""
    f = gf.ext_mul_base(_factor(pt[n - 1], _pow2k(omega, n - 1), 2), scale % host.P)
    fs = [f]
    for l in range(1, n):
        b = n - 1 - l
        h = _factor(pt[b], _pow2k(omega, b), 1 << (l + 1))
        f = gf.ext_mul(gf.ext_concatenate([f, f]), h)
        fs.append(f)
    return fs


def delegate_prove(fs, q: GF2, row_pt: GF2, omega: int, n: int, dt):
    """Chain of n - 1 sumchecks reducing phi~(q) to the O(1) base table.

    `q` is the evaluation point (it drives the eq tables); `row_pt` is the
    point that defines the phi row (its coordinates parameterise the level
    tables h_l, as they did the partial products `fs`). Products are
    [eq, f, h] in that order."""
    proofs, evals = [], []
    q_cur = q
    for l in range(n - 1, 0, -1):
        b = n - 1 - l
        f_prev = fs[l - 1]
        rows = [
            mle_mod.eq_table(q_cur),
            gf.ext_concatenate([f_prev, f_prev]),
            _factor(row_pt[b], _pow2k(omega, b), 1 << (l + 1)),
        ]
        vp = VirtualPolynomial.new(l + 1)
        vp.add_mle_rows(gf.ext_stack(rows))
        vp.add_product((1, 0), [0, 1, 2])
        out = prove_device(vp, dt)
        proofs.append(out.proof)
        evals.append(out.final_evals)
        q_cur = out.proof.point[:l]
    return proofs, evals


def _h_closed_form(r_b: ExtPair, omega_b: int, u: list) -> ExtPair:
    """h~(u) = (1 - r') + r' prod_j ((1 - u_j) + u_j w'^(2^j)) (host)."""
    prod = (1, 0)
    w = omega_b % host.P
    for uj in u:
        prod = host.ext_mul(prod, host.ext_add(_one_minus(uj), host.ext_mul(uj, (w, 0))))
        w = w * w % host.P
    return host.ext_add(_one_minus(r_b), host.ext_mul(r_b, prod))


def delegate_verify(proofs, evals, r1: list, omega: int, n: int, scale: int, q: list,
                    claimed: ExtPair, transcript) -> None:
    """Walk the delegation chain down to the O(1) base check (host)."""
    assert len(proofs) == n - 1, "delegation chain length"
    q_cur, v = list(q), claimed
    for i, l in enumerate(range(n - 1, 0, -1)):
        sub = sumcheck_verify(v, proofs[i].round_messages, l + 1, 3, transcript)
        u = list(sub.point)
        b = n - 1 - l
        h_e = _h_closed_form(r1[b], _pow2k(omega, b), u)
        f_eval = evals[i][1]
        got = host.ext_mul(host.ext_mul(host.ext_eq_eval(q_cur, u), f_eval), h_e)
        assert got == sub.expected_evaluation, f"delegation level {l} mismatch"
        assert evals[i][2] == h_e, f"delegation h claim mismatch at level {l}"
        v = f_eval
        q_cur = u[:l]
    # base: f_0~(q) = scale ((1 - r_(n-1)) + r_(n-1) ((1 - q0) + q0 w^(2^(n-1))))
    (q0,) = q_cur
    inner = host.ext_add(_one_minus(q0), host.ext_mul(q0, (_pow2k(omega, n - 1), 0)))
    r_top = r1[n - 1]
    f0 = host.ext_mul((scale % host.P, 0), host.ext_add(_one_minus(r_top), host.ext_mul(r_top, inner)))
    assert v == f0, "delegation base-table mismatch"


def _freq_prod(x_fft: torch.Tensor, w_freq: torch.Tensor) -> torch.Tensor:
    """prod[i] = sum_j X_j o W^_ij: x_fft (kx, N), w_freq (kw, kx, N) -> (kw, N)."""
    return gf.sum_axis(gf.mul(x_fft.unsqueeze(0), w_freq), 1)


def _centered(c: torch.Tensor, bound: int) -> torch.Tensor:
    """Field values -> signed Elements, assuming |value| < bound: a value
    above p - bound (unsigned) is negative."""
    neg = gf._ult(torch.full_like(c, gf.as_i64(host.P - bound)), c)
    return torch.where(neg, c - gf.P_I64, c)


@dataclasses.dataclass
class Convolution:
    """filter (kw, kx, k, k) and bias (kw,) int64 tensors, for (kx, n, n)
    inputs with n a power of two; stride a power of two below n."""

    filter: torch.Tensor
    bias: torch.Tensor
    input_shape: tuple
    stride: int = 1

    def __post_init__(self):
        self.filter = self.filter.to(torch.int64)
        kx, n, n2 = self.input_shape
        assert n == n2 and n & (n - 1) == 0, "square pow2 inputs"
        s = int(self.stride)
        assert s >= 1 and s & (s - 1) == 0 and s < n, "stride must be pow2 < n"
        self.kw = next_pow2(self.filter.shape[0])
        self.kx = next_pow2(kx)
        self.k = self.filter.shape[2]
        self.n = n
        self.N = 2 * n * n
        b = torch.zeros(self.kw, dtype=torch.int64, device=self.filter.device)
        b[: self.bias.numel()] = self.bias.to(device=b.device, dtype=torch.int64)
        self.bias = b
        self._freq_cache = None
        self._conv_cache = None

    @property
    def is_provable(self) -> bool:
        return True

    # -- data plumbing -------------------------------------------------------
    def _w_tilde(self) -> torch.Tensor:
        """Each (k, k) filter embedded in the n x n grid, flat, zero-padded
        to N: (kw, kx, N)."""
        kw_r, kx_r, k, _ = self.filter.shape
        grid = torch.zeros((self.kw, self.kx, self.n, self.n), dtype=torch.int64, device=self.filter.device)
        grid[:kw_r, :kx_r, :k, :k] = self.filter
        out = torch.zeros((self.kw, self.kx, self.N), dtype=torch.int64, device=grid.device)
        out[:, :, : self.n * self.n] = grid.reshape(self.kw, self.kx, -1)
        return out

    def freq_weights(self) -> torch.Tensor:
        """W^(i, j, k) = FFT(w~_ij)[k], flat: the committed weight polynomial."""
        if self._freq_cache is None:
            wt = Q.to_field(self._w_tilde().reshape(self.kw * self.kx, self.N))
            self._freq_cache = ntt.fft_rows(wt).reshape(-1)
        return self._freq_cache

    def _x_tilde(self, x: torch.Tensor) -> torch.Tensor:
        """(kx, N): per channel reverse(flatten(x_j)) then zeros."""
        out = torch.zeros((self.kx, self.N), dtype=torch.int64, device=x.device)
        out[: x.shape[0], : self.n * self.n] = x.reshape(x.shape[0], -1).flip(1)
        return out

    def mask(self, device) -> torch.Tensor:
        """Valid-position 0/1 mask over p in [0, n^2)."""
        m = torch.zeros((self.n, self.n), dtype=torch.int64, device=device)
        v = self.n - self.k + 1
        m[:v, :v] = 1
        return m.reshape(-1)

    def _conv_field(self, x: torch.Tensor):
        """(c (kw, N), B (kw, n^2) Elements, x~ (kx, N) field, X (kx, N), prod
        (kw, N)). Kept for the input tensor object it was computed from:
        inference computes it and `prove` reuses the very arrays, with no
        FFT and no copy to the host."""
        cached = self._conv_cache
        if cached is not None and cached[0] is x:
            return cached[1]
        x_gf = Q.to_field(self._x_tilde(x))
        x_fft = ntt.fft_rows(x_gf)
        prod = _freq_prod(x_fft, self.freq_weights().reshape(self.kw, self.kx, self.N))
        c = ntt.fft_rows(prod, inverse=True)
        n2 = self.n * self.n
        c_elem = _centered(c, 1 << self.output_bitsize())
        b_vals = c_elem[:, :n2].flip(1) + self.bias[:, None]
        out = (c, b_vals, x_gf, x_fft, prod)
        self._conv_cache = (x, out)
        return out

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = inputs[0].data
        b_vals = self._conv_field(x)[1]
        out = (b_vals * self.mask(x.device)[None, :]).reshape(self.kw, self.n, self.n)
        if self.stride > 1:
            out = out[:, :: self.stride, :: self.stride].contiguous()
        return [Tensor(out)]

    def output_bitsize(self) -> int:
        kxk2 = self.filter.shape[1] * self.k * self.k
        return 2 * (Q.BIT_LEN - 1) + ceil_log2(max(2, kxk2)) + 2

    # -- context -------------------------------------------------------------
    def step_info(self, node_id: int, aux):
        aux.model_polys[node_id] = {
            WEIGHT_POLY_ID: self.freq_weights(),
            BIAS_POLY_ID: Q.to_field(self.bias),
        }
        return ConvCtx(node_id=node_id, kw=self.kw, kx=self.kx, n=self.n, k=self.k, stride=self.stride)

    # -- proving -------------------------------------------------------------
    def _full_grid_claim(self, claim):
        """A strided output claim as a claim on the full grid: `log_s`
        constant-zero variables inserted at the low bits of each axis
        (eq(x_b, 0) selects even indices)."""
        ls = ceil_log2(self.stride)
        lc = ceil_log2(self.n) - ls
        pt = claim.point
        zeros = gf.ext_zeros((ls,), pt.device)
        full = gf.ext_concatenate([zeros, pt[:lc], zeros, pt[lc:]])
        return glue.DevClaim(point=full, eval=claim.eval)

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        dt = prover.dt
        dev = dt.device
        last_claim = last_claims[0]
        if self.stride > 1:
            last_claim = self._full_grid_claim(last_claim)
        log_p = ceil_log2(self.n * self.n)
        log_i, log_j, log_t = ceil_log2(self.kw), ceil_log2(self.kx), ceil_log2(self.N)
        _, b_vals, x_gf, x_fft, prod = self._conv_field(step_data.inputs[0].data)

        # 1. clearing sumcheck: sum eq mask B over (p, i)
        vp = VirtualPolynomial.new(log_p + log_i)
        vp.add_mle(mle_mod.eq_table(last_claim.point))
        vp.add_mle(self.mask(dev).repeat(self.kw))
        vp.add_mle(Q.to_field(b_vals.reshape(-1)))
        vp.add_product((1, 0), [0, 1, 2])
        sc1 = prove_device(vp, dt)
        s0 = sc1.proof.point
        s0_p, s0_i = s0[:log_p], s0[log_p:]

        # 2. bias and the reversal/slice point rewrite
        bias_gf = prover.ctx.commitment_ctx.model_comms[node_id][BIAS_POLY_ID][1]
        bias_eval = mle_mod.evaluate(bias_gf, s0_i)
        sigma_t = gf.ext_concatenate([_one_minus_dev(s0_p), gf.ext_zeros((1,), dev)])

        # 3. iFFT sumcheck over k: c~(sigma, s0_i) = sum_k phi_inv[k] prod~(k, s0_i)
        omega = ntt.subgroup_gen(log_t)
        omega_inv = pow(omega, host.P - 2, host.P)
        n_inv = pow(self.N, host.P - 2, host.P)
        fs_inv = phi_partials(sigma_t, omega_inv, log_t, n_inv)
        vp2 = VirtualPolynomial.new(log_t)
        vp2.add_mle(fs_inv[-1])
        vp2.add_mle(mle_mod.fix_high_variables(prod.reshape(-1), s0_i))
        vp2.add_product((1, 0), [0, 1])
        sc2 = prove_device(vp2, dt)
        s1 = sc2.proof.point
        deleg_inv = delegate_prove(fs_inv, s1, sigma_t, omega_inv, log_t, dt)

        # 4. hadamard sumcheck over (k, j, i): eq(k, i) X(j, k) W^(i, j, k)
        shape = (self.kw, self.kx, self.N)
        eq = gf.ext_mul(
            mle_mod.eq_table(s1).reshape(1, 1, self.N), mle_mod.eq_table(s0_i).reshape(self.kw, 1, 1)
        )
        vp3 = VirtualPolynomial.new(log_t + log_j + log_i)
        vp3.add_mle(GF2(eq.a0.expand(shape).reshape(-1), eq.a1.expand(shape).reshape(-1)))
        vp3.add_mle(x_fft.unsqueeze(0).expand(shape).reshape(-1))
        vp3.add_mle(self.freq_weights())
        vp3.add_product((1, 0), [0, 1, 2])
        sc3 = prove_device(vp3, dt)
        s2 = sc3.proof.point
        s2_k, s2_j = s2[:log_t], s2[log_t : log_t + log_j]
        prover.commit_prover.add_common_claims(
            node_id,
            {
                WEIGHT_POLY_ID: glue.DevClaim(point=s2, eval=sc3.final_evals[2]),
                BIAS_POLY_ID: glue.DevClaim(point=s0_i, eval=bias_eval),
            },
        )

        # 5. FFT sumcheck over t: X~(s2_k, s2_j) = sum_t phi_fft[t] x~~(t, s2_j)
        fs_fft = phi_partials(s2_k, omega, log_t, 1)
        vp4 = VirtualPolynomial.new(log_t)
        vp4.add_mle(fs_fft[-1])
        vp4.add_mle(mle_mod.fix_high_variables(x_gf.reshape(-1), s2_j))
        vp4.add_product((1, 0), [0, 1])
        sc4 = prove_device(vp4, dt)
        s3 = sc4.proof.point
        deleg_fft = delegate_prove(fs_fft, s3, s2_k, omega, log_t, dt)

        # 6. x~ -> x in closed form: x~~(s3_p, s3_top, r_j) = (1 - s3_top) x~(1 - s3_p, r_j)
        inv_top = gf.ext_inv(_one_minus_dev(s3[log_t - 1]))
        x_eval = gf.ext_mul(sc4.final_evals[1], inv_top)
        x_point = gf.ext_concatenate([_one_minus_dev(s3[: log_t - 1]), s2_j])

        prover.push_proof(
            node_id,
            ConvProof(
                clearing=sc1.proof, clearing_evals=sc1.final_evals,
                ifft=sc2.proof, ifft_evals=sc2.final_evals,
                hadamard=sc3.proof, hadamard_evals=sc3.final_evals,
                fft=sc4.proof, fft_evals=sc4.final_evals,
                bias_eval=bias_eval,
                delegation_inv=list(deleg_inv),
                delegation_fft=list(deleg_fft),
                sigma_t=sigma_t,
            ),
        )
        return [glue.DevClaim(point=x_point, eval=x_eval)]


@dataclasses.dataclass
class ConvProof:
    clearing: object
    clearing_evals: object
    ifft: object
    ifft_evals: object
    hadamard: object
    hadamard_evals: object
    fft: object
    fft_evals: object
    bias_eval: object
    # the delegation chains: [[sumcheck proofs], [final evals]] each
    delegation_inv: list = None
    delegation_fft: list = None
    sigma_t: object = None


@dataclasses.dataclass
class ConvCtx:
    node_id: int
    kw: int
    kx: int
    n: int
    k: int
    stride: int = 1

    @property
    def is_provable(self) -> bool:
        return True

    def _mask_field(self) -> np.ndarray:
        m = np.zeros((self.n, self.n), dtype=np.uint64)
        v = self.n - self.k + 1
        m[:v, :v] = 1
        return np.tile(m.reshape(-1), self.kw)

    def verify(self, proof: ConvProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        tr = verifier.transcript
        n2 = self.n * self.n
        log_p, log_i = ceil_log2(n2), ceil_log2(self.kw)
        log_j, log_t = ceil_log2(self.kx), ceil_log2(2 * n2)

        if self.stride > 1:
            ls = ceil_log2(self.stride)
            lc = ceil_log2(self.n) - ls
            pt = list(last_claim.point)
            z = [(0, 0)] * ls
            last_claim = Claim(point=z + pt[:lc] + z + pt[lc:], eval=last_claim.eval)

        # 1. clearing
        sub1 = sumcheck_verify(last_claim.eval, proof.clearing.round_messages, log_p + log_i, 3, tr)
        s0 = sub1.point
        s0_p, s0_i = s0[:log_p], s0[log_p:]
        b_eval = proof.clearing_evals[2]
        got = host.ext_mul(
            host.ext_mul(host.ext_eq_eval(last_claim.point, s0), host.mle_eval_v(self._mask_field(), s0)),
            b_eval,
        )
        assert got == sub1.expected_evaluation, "conv clearing mismatch"

        # 2. bias and reversal rewrite
        c_rev_eval = host.ext_sub(b_eval, proof.bias_eval)
        sigma_t = [_one_minus(pq) for pq in s0_p] + [(0, 0)]

        # 3. iFFT sumcheck; phi_inv~(s1) is the prover's claim, proven by delegation
        sub2 = sumcheck_verify(c_rev_eval, proof.ifft.round_messages, log_t, 2, tr)
        s1 = sub2.point
        omega = ntt.subgroup_gen(log_t)
        omega_inv = pow(omega, host.P - 2, host.P)
        n_inv = pow(2 * n2, host.P - 2, host.P)
        phi_inv_eval, prod_eval = proof.ifft_evals[0], proof.ifft_evals[1]
        assert host.ext_mul(phi_inv_eval, prod_eval) == sub2.expected_evaluation, "conv ifft mismatch"
        delegate_verify(
            proof.delegation_inv[0], proof.delegation_inv[1], sigma_t,
            omega_inv, log_t, n_inv, s1, phi_inv_eval, tr,
        )

        # 4. hadamard sumcheck
        sub3 = sumcheck_verify(prod_eval, proof.hadamard.round_messages, log_t + log_j + log_i, 3, tr)
        s2 = sub3.point
        s2_k, s2_j, s2_i = s2[:log_t], s2[log_t : log_t + log_j], s2[log_t + log_j :]
        eq_full = host.ext_mul(host.ext_eq_eval(s1, s2_k), host.ext_eq_eval(s0_i, s2_i))
        x_eval, w_eval = proof.hadamard_evals[1], proof.hadamard_evals[2]
        got = host.ext_mul(host.ext_mul(eq_full, x_eval), w_eval)
        assert got == sub3.expected_evaluation, "conv hadamard mismatch"
        verifier.commit_verifier.add_common_claims(
            self.node_id,
            {
                WEIGHT_POLY_ID: Claim(point=list(s2), eval=w_eval),
                BIAS_POLY_ID: Claim(point=list(s0_i), eval=proof.bias_eval),
            },
        )

        # 5. FFT sumcheck
        sub4 = sumcheck_verify(x_eval, proof.fft.round_messages, log_t, 2, tr)
        s3 = sub4.point
        phi_fft_eval, xt_eval = proof.fft_evals[0], proof.fft_evals[1]
        assert host.ext_mul(phi_fft_eval, xt_eval) == sub4.expected_evaluation, "conv fft mismatch"
        delegate_verify(
            proof.delegation_fft[0], proof.delegation_fft[1], s2_k,
            omega, log_t, 1, s3, phi_fft_eval, tr,
        )

        # 6. the input claim in closed form
        x_eval_final = host.ext_mul(xt_eval, host.ext_inv(_one_minus(s3[-1])))
        x_point = [_one_minus(pq) for pq in s3[:-1]] + list(s2_j)
        return [Claim(point=x_point, eval=x_eval_final)]
