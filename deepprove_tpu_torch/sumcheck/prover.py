"""Sumcheck prover over torch tensors: the plain per-round path.

Proves sum_{b in {0,1}^n} sum_i c_i * prod_j f_ij(b) with one univariate
message per round, with the transcript discipline of the JAX package's
`sumcheck/prover.py`: absorb n and max_degree, then per round absorb the
message evaluations at t = 0..max_degree and squeeze a b"Internal round"
challenge. Each round folds the previous challenge into every MLE and
computes the message in eager torch ops, one session call to absorb and
squeeze. The MLEs fold as one stacked (m, 2^n) array and a round gathers
every product's factors from it at once, so its ops do not grow with the
number of products. A product of lower degree than max_degree takes a row
of ones for its missing factors. The messages equal the JAX prover's.

An MLE may be shorter than 2^n: a row of 2^l entries stands for its tiling
over the high variables. Such rows fold at their own length (a row folded
past its length is a constant), and a round sums each product over one
period of its factors, the longest factor's pairs, times the number of
periods in the round, which is what the tiled rows sum to.

The main path runs `fused.py` (the rounds as CUDA kernels on a CUDA
session); on a CPU session `fused.prove_device` runs this path, which is
also the plain version the kernels are held against.
"""

from __future__ import annotations

import dataclasses

import torch

from ..fields import gf
from ..fields.gf import GF2
from ..transcript.session import label_chunks

ExtPair = tuple[int, int]

ROUND_LABEL = b"Internal round"
ROUND_CHUNKS = tuple(label_chunks(ROUND_LABEL))


@dataclasses.dataclass
class VirtualPolynomial:
    """sum_i coeff_i * prod_j mles[idx_ij] over {0,1}^num_vars; a coeff is
    a host pair or a device GF2 (). `coeffs_dev`, when set, is a device
    GF2 (num products,) that replaces the products' own coefficients."""

    num_vars: int
    mles: list
    products: list
    num_mles: int = 0
    coeffs_dev: GF2 | None = None

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
        """One MLE (length 2^l, l <= num_vars, base or GF2: a shorter one
        stands for its tiling over the high variables); returns its index."""
        self.mles.append(values.reshape(1, -1))
        self.num_mles += 1
        return self.num_mles - 1

    def add_mle_rows(self, rows) -> int:
        """Several MLEs given as the rows of one (k, 2^l) array; returns the
        index of the first (the rest follow in row order)."""
        self.mles.append(rows)
        self.num_mles += rows.shape[0]
        return self.num_mles - rows.shape[0]


@dataclasses.dataclass
class SumcheckProof:
    """Challenge point + per-round messages (evals at t = 0..max_degree)."""

    point: object  # GF2 (n,) on the device; host [pairs] once materialized
    round_messages: object  # GF2 (n, max_degree + 1); host [[pairs]]


@dataclasses.dataclass
class ProverOutput:
    proof: SumcheckProof
    final_evals: object  # GF2 (num mles,): each MLE fully folded


# factor rows a round gathers at once; bounds the temporaries of the first
# rounds of a wide sumcheck (the batch opening's 2^20-entry MLEs)
_GATHER_ELEMS = 1 << 22


def _stacked(vp: VirtualPolynomial, degree: int):
    """All MLEs as one GF2 (m, 2^n) array, plus a row of ones when a product
    has fewer than `degree` factors (the missing factors point at it)."""
    rows = [gf.to_ext(m) for m in vp.mles]
    if any(len(f) < degree for _, f in vp.products):
        rows.append(gf.ext_ones((1, rows[0].shape[1]), rows[0].device))
    return gf.ext_concatenate(rows) if len(rows) > 1 else rows[0]


def _is_ragged(vp: VirtualPolynomial) -> bool:
    return any(m.shape[-1] != 1 << vp.num_vars for m in vp.mles)


class _Ragged:
    """Rows of different lengths, grouped by length: {length: GF2 (k, L)}
    and each row's (length, position); the ones row has one entry."""

    def __init__(self, vp: VirtualPolynomial, degree: int):
        rows = [gf.to_ext(m) for m in vp.mles]
        if any(len(f) < degree for _, f in vp.products):
            rows.append(gf.ext_ones((1, 1), rows[0].device))
        parts: dict = {}
        self.where = []
        for r in rows:
            lst = parts.setdefault(r.shape[1], [])
            first = sum(p.shape[0] for p in lst)
            self.where += [(r.shape[1], first + i) for i in range(r.shape[0])]
            lst.append(r)
        self.groups = {n: gf.ext_concatenate(ps) for n, ps in parts.items()}

    def fold(self, r: GF2) -> None:
        """Bind the lowest variable of every row; a row of one entry stays."""
        parts: dict = {}
        base = {}
        for n, g in sorted(self.groups.items()):
            lst = parts.setdefault(max(1, n // 2), [])
            base[n] = sum(p.shape[0] for p in lst)
            lst.append(_fold_rows(g, r) if n > 1 else g)
        self.where = [(max(1, n // 2), base[n] + pos) for n, pos in self.where]
        self.groups = {n: gf.ext_concatenate(ps) for n, ps in parts.items()}

    def row(self, i: int) -> GF2:
        n, pos = self.where[i]
        return self.groups[n][pos]

    def message(self, products, coeffs: GF2, degree: int, pairs: int) -> GF2:
        """The round message: each product over one period of its factors
        (the longest's pairs, Q), times pairs / Q, by groups of equal Q."""
        by_period: dict = {}
        for p, (_, factors) in enumerate(products):
            q = max(max(1, self.where[f][0] // 2) for f in factors)
            by_period.setdefault(q, []).append(p)
        total = None
        for q, prods in sorted(by_period.items()):
            used = sorted({f for p in prods for f in products[p][1]})
            local = {f: i for i, f in enumerate(used)}
            tiled = []
            for f in used:
                r = self.row(f)
                tiled.append(GF2(r.a0.repeat(2 * q // r.shape[0]), r.a1.repeat(2 * q // r.shape[0])))
            stacked = gf.ext_stack(tiled)
            idx = torch.tensor([[local[f] for f in products[p][1]] for p in prods], dtype=torch.int64,
                               device=stacked.device)
            sub = _round_message(stacked, idx, coeffs[torch.tensor(prods, device=stacked.device)], degree)
            sub = gf.ext_mul_base(sub, gf.full((), pairs // q, stacked.device))
            total = sub if total is None else gf.ext_add(total, sub)
        return total

    def finals(self, m: int) -> GF2:
        return gf.ext_stack([self.row(i).reshape(()) for i in range(m)])


def _coeffs(vp: VirtualPolynomial, device) -> GF2:
    if vp.coeffs_dev is not None:
        return vp.coeffs_dev
    cs = [c for c, _ in vp.products]
    if all(not isinstance(c, GF2) for c in cs):
        return gf.ext_from_pairs(cs, device)
    return gf.ext_stack([c if isinstance(c, GF2) else gf.ext_scalar(c, device) for c in cs])


def _factor_index(vp: VirtualPolynomial, degree: int, device) -> torch.Tensor:
    ones = vp.num_mles
    return torch.tensor(
        [list(f) + [ones] * (degree - len(f)) for _, f in vp.products],
        dtype=torch.int64, device=device,
    )


def _products_sum(cur: GF2, idx: torch.Tensor, coeffs: GF2) -> GF2:
    """sum_p coeffs[p] * sum_x prod_j cur[idx[p, j], x], in chunks of products."""
    n_prod, degree = idx.shape
    chunk = max(1, _GATHER_ELEMS // max(1, degree * cur.shape[1]))
    total = None
    for s in range(0, n_prod, chunk):
        ii = idx[s : s + chunk]
        f = GF2(cur.a0[ii], cur.a1[ii])  # (chunk, degree, L)
        p = f[:, 0]
        for j in range(1, degree):
            p = gf.ext_mul(p, f[:, j])
        part = gf.ext_sum_axis(gf.ext_mul(coeffs[s : s + chunk], gf.ext_sum_axis(p, 1)), 0)
        total = part if total is None else gf.ext_add(total, part)
    return total


def _round_message(stacked: GF2, idx: torch.Tensor, coeffs: GF2, degree: int) -> GF2:
    lo, hi = stacked[:, 0::2], stacked[:, 1::2]
    diff = gf.ext_sub(hi, lo) if degree >= 2 else None
    evals = []
    cur = lo
    for t in range(degree + 1):
        if t == 1:
            cur = hi
        elif t >= 2:
            cur = gf.ext_add(cur, diff)
        evals.append(_products_sum(cur, idx, coeffs))
    return gf.ext_stack(evals)


def _fold_rows(stacked: GF2, r: GF2) -> GF2:
    """Bind the lowest variable of every row to r."""
    lo, hi = stacked[:, 0::2], stacked[:, 1::2]
    return gf.ext_add(lo, gf.ext_mul(r, gf.ext_sub(hi, lo)))


def prove_device(vp: VirtualPolynomial, dt) -> ProverOutput:
    """Sumcheck against a session transcript; the output holds device
    values (lower with glue.materialize). The rounds run on the device of
    the MLEs, which may differ from the session's (the CUDA kernels' plain
    reference runs torch on the card against a CPU session)."""
    device = vp.mles[0].device
    n = vp.num_vars
    degree = vp.max_degree
    dt.append_constants([n, degree])
    coeffs = _coeffs(vp, device)
    ragged = _Ragged(vp, degree) if _is_ragged(vp) else None
    if ragged is None:
        stacked = _stacked(vp, degree)
        idx = _factor_index(vp, degree, device)
    else:
        ones = vp.num_mles
        products = [(c, list(f) + [ones] * (degree - len(f))) for c, f in vp.products]
    msgs, point = [], []
    for rnd in range(n):
        if ragged is None:
            if rnd:
                stacked = _fold_rows(stacked, point[-1])
            msg = _round_message(stacked, idx, coeffs, degree)
        else:
            if rnd:
                ragged.fold(point[-1])
            msg = ragged.message(products, coeffs, degree, 1 << (n - rnd - 1))
        msgs.append(msg)
        r = dt.step(arr=msg, labels=(ROUND_CHUNKS,), k=1)
        point.append(GF2(r.a0.to(device), r.a1.to(device)).reshape(()))
    if n:
        proof = SumcheckProof(point=gf.ext_stack(point), round_messages=gf.ext_stack(msgs))
        if ragged is None:
            stacked = _fold_rows(stacked, point[-1])
        else:
            ragged.fold(point[-1])
    else:
        empty = gf.ext_zeros((0,), device)
        proof = SumcheckProof(point=empty, round_messages=gf.ext_zeros((0, degree + 1), device))
    finals = stacked[: vp.num_mles].reshape(-1) if ragged is None else ragged.finals(vp.num_mles)
    return ProverOutput(proof=proof, final_evals=finals)


def prove(vp: VirtualPolynomial, transcript) -> ProverOutput:
    """Host-transcript API: runs on the device of the MLEs, returns host
    values and advances `transcript`."""
    from ..transcript.session import DeviceTranscript

    dt = DeviceTranscript.from_host(transcript, vp.mles[0].device)
    return dt.materialize(prove_device(vp, dt), transcript)
