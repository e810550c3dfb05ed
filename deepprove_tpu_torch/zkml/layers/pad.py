"""Pad2D: spatial zero-padding as a provable layer, as in the JAX package's
`zkml/layers/pad.py`.

out(ch, r, c) = x(ch, r - p, c - p) for p <= r, c < n + p, else 0: the
input side of an ONNX `Conv(pads=[p, p, p, p])`, which turns it into the
stride-1, pad-0 convolution the FFT protocol proves.

Proof (one degree-2 sumcheck): out is a linear function of x, so a claim
(s, y) on the padded tensor is y = sum_v w_s(v) x~(v) with
    w_s(v) = eq(s_ch, v_ch) eqshift_p(s_r, v_r) eqshift_p(s_c, v_c),
    eqshift_p(s, v) = prod_b [s_b bit_b(v + p) + (1 - s_b)(1 - bit_b(v + p))].
The prover builds w_s on the device from bit tables of v + p; the verifier
evaluates w_s~ at the sumcheck's final point with a carry DP over the bits
of v + p (O(log^2 n) host work). Output: one claim on x.
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
from ..tensor import Tensor, ceil_log2, next_pow2


@dataclasses.dataclass
class Pad2D:
    """Zero-pad a (C, n, n) tensor by `pad` on every spatial edge; the output
    grid is next_pow2(n + 2 pad) square, the channels padded to a power of
    two."""

    pad: int
    input_shape: tuple  # (C, n, n)

    def __post_init__(self):
        c, n, n2 = self.input_shape
        assert n == n2 and n & (n - 1) == 0, "square pow2 inputs"
        self.c = next_pow2(c)
        self.n = n
        self.n_out = next_pow2(n + 2 * self.pad)

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = inputs[0].data.reshape(-1, self.n, self.n)
        out = torch.zeros((self.c, self.n_out, self.n_out), dtype=torch.int64, device=x.device)
        p = self.pad
        out[: x.shape[0], p : p + self.n, p : p + self.n] = x
        return [Tensor(out)]

    def step_info(self, node_id: int, aux):
        return PadCtx(node_id=node_id, pad=self.pad, c=self.c, n=self.n, n_out=self.n_out)

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        log_no, log_n, log_c = ceil_log2(self.n_out), ceil_log2(self.n), ceil_log2(self.c)
        s = last_claims[0].point  # [col, row, ch], low first
        w = pad_weights(s[:log_no], s[log_no : 2 * log_no], s[2 * log_no :], self.pad, log_n)
        vp = VirtualPolynomial.new(2 * log_n + log_c)
        vp.add_product((1, 0), [vp.add_mle(w), vp.add_mle(step_data.inputs[0].to_field())])
        out = prove_device(vp, prover.dt)
        prover.push_proof(node_id, PadProof(sumcheck=out.proof, individual_claims=out.final_evals))
        return [glue.DevClaim(point=out.proof.point, eval=glue.at(out.final_evals, 1))]


def _eqshift(s_bits: GF2, pad: int, length_log: int) -> GF2:
    """t[v] = prod_b eq(s_b, bit_b(v + pad)) for v in [0, 2^length_log)."""
    dev = s_bits.device
    idx = torch.arange(1 << length_log, dtype=torch.int64, device=dev) + pad
    t = gf.ext_ones((1 << length_log,), dev)
    one = gf.ext_ones((), dev)
    for b in range(s_bits.shape[0]):
        bit = ((idx >> b) & 1) == 1
        sb, nsb = s_bits[b], gf.ext_sub(one, s_bits[b])
        factor = GF2(torch.where(bit, sb.a0, nsb.a0), torch.where(bit, sb.a1, nsb.a1))
        t = gf.ext_mul(t, factor)
    return t


def _outer(low: GF2, high: GF2) -> GF2:
    """(B,) x (A,) -> (B A,) flat, `low`'s index the low one."""
    a = GF2(low.a0[None, :].expand(high.shape[0], -1), low.a1[None, :].expand(high.shape[0], -1))
    b = GF2(high.a0[:, None].expand(-1, low.shape[0]), high.a1[:, None].expand(-1, low.shape[0]))
    return gf.ext_mul(a, b).reshape(-1)


def pad_weights(s_c: GF2, s_r: GF2, s_ch: GF2, pad: int, log_n: int) -> GF2:
    """w_s over {0,1}^(2 log_n + log_c): eqshift_p on each spatial axis times
    eq over the channels, laid out [col low, row, ch high]."""
    w_rc = _outer(_eqshift(s_c, pad, log_n), _eqshift(s_r, pad, log_n))
    return _outer(w_rc, mle_mod.eq_table(s_ch))


@dataclasses.dataclass
class PadProof:
    sumcheck: object
    individual_claims: object


def eqshift_closed(s: list, t: list, pad: int) -> tuple[int, int]:
    """sum_v eq(t, v) prod_b eq(s_b, bit_b(v + pad)) by a carry DP over the
    bits (O(log^2)): s the output axis's bits, t the input axis's; v + pad
    stays below 2^len(s)."""
    one = (1, 0)
    a = {0: one, 1: (0, 0)}  # by carry, after the bits so far
    for b in range(len(s)):
        p_b = (pad >> b) & 1
        nxt = {0: (0, 0), 1: (0, 0)}
        for c_in in (0, 1):
            if a[c_in] == (0, 0):
                continue
            for v_b in (0, 1):
                if b >= len(t) and v_b == 1:  # v's bits above the input axis are zero
                    continue
                tot = v_b + p_b + c_in
                o_b, c_out = tot & 1, tot >> 1
                term = a[c_in]
                if b < len(t):
                    term = host.ext_mul(term, t[b] if v_b else host.ext_sub(one, t[b]))
                term = host.ext_mul(term, s[b] if o_b else host.ext_sub(one, s[b]))
                nxt[c_out] = host.ext_add(nxt[c_out], term)
        a = nxt
    return a[0]


@dataclasses.dataclass
class PadCtx:
    node_id: int
    pad: int
    c: int
    n: int
    n_out: int

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: PadProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        log_no, log_n, log_c = ceil_log2(self.n_out), ceil_log2(self.n), ceil_log2(self.c)
        sub = sumcheck_verify(
            last_claim.eval, proof.sumcheck.round_messages, 2 * log_n + log_c, 2, verifier.transcript
        )
        t = list(sub.point)
        s = list(last_claim.point)
        w_eval = host.ext_mul(
            host.ext_mul(eqshift_closed(s[:log_no], t[:log_n], self.pad),
                         eqshift_closed(s[log_no : 2 * log_no], t[log_n : 2 * log_n], self.pad)),
            host.ext_eq_eval(s[2 * log_no :], t[2 * log_n :]),
        )
        x_eval = proof.individual_claims[1]
        assert host.ext_mul(w_eval, x_eval) == sub.expected_evaluation, "pad sumcheck final mismatch"
        return [Claim(point=t, eval=x_eval)]
