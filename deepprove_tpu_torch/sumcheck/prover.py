"""Sumcheck prover over torch tensors.

Proves sum_{b in {0,1}^n} sum_i c_i * prod_j f_ij(b) with one univariate
message per round, with the transcript discipline of the JAX package's
`sumcheck/prover.py` and `fused.py:prove_device`: absorb n and max_degree,
then per round absorb the message evaluations at t = 0..max_degree and
squeeze a b"Internal round" challenge. Each round folds the previous
challenge into every MLE and computes the message on the device; the
session transcript copies the message down and hands the challenge back.
Products of lower degree than max_degree need no padding: a missing
factor is a factor of one. The messages equal the JAX prover's.
"""

from __future__ import annotations

import dataclasses

from ..fields import gf
from ..fields.gf import GF2
from ..poly import mle as mle_mod

ExtPair = tuple[int, int]

ROUND_LABEL = b"Internal round"


@dataclasses.dataclass
class VirtualPolynomial:
    """sum_i coeff_i * prod_j mles[idx_ij] over {0,1}^num_vars; a coeff is
    a host pair or a device GF2 ()."""

    num_vars: int
    mles: list
    products: list

    @property
    def max_degree(self) -> int:
        return max(len(idx) for _, idx in self.products)

    def add_product(self, coeff, factors: list[int]):
        if isinstance(coeff, int):
            coeff = (coeff, 0)
        self.products.append((coeff, factors))

    @staticmethod
    def new(num_vars: int) -> "VirtualPolynomial":
        return VirtualPolynomial(num_vars=num_vars, mles=[], products=[])

    def add_mle(self, values) -> int:
        self.mles.append(values)
        return len(self.mles) - 1


@dataclasses.dataclass
class SumcheckProof:
    """Challenge point + per-round messages (evals at t = 0..max_degree)."""

    point: object  # GF2 (n,) on the device; host [pairs] once materialized
    round_messages: object  # GF2 (n, max_degree + 1); host [[pairs]]


@dataclasses.dataclass
class ProverOutput:
    proof: SumcheckProof
    final_evals: object  # GF2 (num mles,): each MLE fully folded


def _round_message(mles: list, products, coeffs: list, degree: int) -> GF2:
    lo = [m[0::2] for m in mles]
    hi = [m[1::2] for m in mles]
    diff = [gf.ext_sub(h, l) for h, l in zip(hi, lo)] if degree >= 2 else None
    evals = []
    cur = lo
    for t in range(degree + 1):
        if t == 1:
            cur = hi
        elif t >= 2:
            cur = [gf.ext_add(c, d) for c, d in zip(cur, diff)]
        total = None
        for coeff, (_, factors) in zip(coeffs, products):
            p = cur[factors[0]]
            for f in factors[1:]:
                p = gf.ext_mul(p, cur[f])
            term = gf.ext_mul(coeff, gf.ext_sum_axis(p, 0))
            total = term if total is None else gf.ext_add(total, term)
        evals.append(total)
    return gf.ext_stack(evals)


def prove_device(vp: VirtualPolynomial, dt) -> ProverOutput:
    """Sumcheck against a session transcript; the output holds device
    values (lower with glue.materialize)."""
    device = dt.device
    n = vp.num_vars
    degree = vp.max_degree
    dt.append_constants([n, degree])
    mles = [gf.to_ext(m) for m in vp.mles]
    coeffs = [c if isinstance(c, GF2) else gf.ext_scalar(c, device) for c, _ in vp.products]
    msgs, point = [], []
    for rnd in range(n):
        if rnd:
            mles = [mle_mod.fix_variable(m, point[-1]) for m in mles]
        msg = _round_message(mles, vp.products, coeffs, degree)
        dt.append_exts(msg)
        msgs.append(msg)
        point.append(dt.get_and_append_challenge(ROUND_LABEL))
    if n:
        mles = [mle_mod.fix_variable(m, point[-1]) for m in mles]
        proof = SumcheckProof(point=gf.ext_stack(point), round_messages=gf.ext_stack(msgs))
    else:
        empty = gf.ext_zeros((0,), device)
        proof = SumcheckProof(point=empty, round_messages=gf.ext_zeros((0, degree + 1), device))
    finals = gf.ext_stack([m.reshape(()) for m in mles])
    return ProverOutput(proof=proof, final_evals=finals)


def prove(vp: VirtualPolynomial, transcript) -> ProverOutput:
    """Host-transcript API: runs on the device of the MLEs, returns host values."""
    from .. import glue
    from ..transcript.session import DeviceTranscript

    dt = DeviceTranscript.from_host(transcript, vp.mles[0].device)
    return glue.materialize(prove_device(vp, dt))
