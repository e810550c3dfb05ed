"""logup-GKR: the fractional-sumcheck lookup argument, as in the JAX
package's `lookup/logup.py`.

  * A circuit is the fraction tree of sum +-1/(alpha_const + sum_k chi^k col_k):
    each layer halves by adding the fractions of its low and high halves,
    n' = n_lo d_hi + n_hi d_lo, d' = d_lo d_hi. A lookup's numerators are an
    implicit -1 at the input layer; a table's are its multiplicities.
  * The prover proves every GKR level with one degree-3 sumcheck of
    eq (n_lo d_hi + n_hi d_lo + lambda d_lo d_hi), alpha-batched over the
    instances; the level's point grows by a per-level batching challenge.
  * Transcript: the instance count and the circuit outputs, then
    initial_batching/alpha/lambda; per level the current claim, the
    sumcheck (level, degree 3, 4 evaluations a round), then
    logup_batching/alpha/lambda.

All instances of one proof share one column size, so their trees are built
together as (instances, width) arrays and each level's sumcheck takes every
instance's rows as one stacked array. The challenges stay on the device, and
the claim algebra is a handful of eager ops on (instances,)-sized device
arrays, as the JAX package's `_initial_claim_kernel`, `_next_claim_kernel`,
`_final_lookup_claim_kernel` and `_level_coeffs_kernel`: the same field
values, claim for claim. The verifier is host code on ext pairs.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import glue
from ..fields import gf, host
from ..fields.gf import GF2
from ..poly import mle as mle_mod
from ..sumcheck import VirtualPolynomial, prove_device
from ..sumcheck import verify as sumcheck_verify
from ..transcript.session import label_chunks

ExtPair = tuple[int, int]

_ONE, _ZERO = (1, 0), (0, 0)


@dataclasses.dataclass
class Claim:
    """Claim{point, eval} with host ext pairs."""

    point: list[ExtPair]
    eval: ExtPair


@dataclasses.dataclass
class LogUpInput:
    """A lookup (columns_per_instance columns an instance) or a table (its
    columns and multiplicities, whose claim comes first in the proof).
    Columns are base tensors of one length 2^n; challenges are device GF2 ()
    scalars or host pairs."""

    column_evals: list
    constant_challenge: ExtPair
    column_separation_challenge: ExtPair
    columns_per_instance: int = 1
    multiplicities: torch.Tensor | None = None
    is_table: bool = False

    @staticmethod
    def new_lookup(columns, constant_challenge, column_separation_challenge, columns_per_instance):
        assert len(columns) % columns_per_instance == 0
        return LogUpInput(
            list(columns), constant_challenge, column_separation_challenge, columns_per_instance
        )

    @staticmethod
    def new_table(columns, multiplicities, constant_challenge, column_separation_challenge):
        return LogUpInput(
            list(columns), constant_challenge, column_separation_challenge,
            columns_per_instance=len(columns), multiplicities=multiplicities, is_table=True,
        )

    @property
    def num_instances(self) -> int:
        return 1 if self.is_table else len(self.column_evals) // self.columns_per_instance

    def base_mles(self):
        """The MLEs whose claims the proof outputs, in claim order."""
        return ([self.multiplicities] if self.is_table else []) + list(self.column_evals)


@dataclasses.dataclass
class LogUpProof:
    sumcheck_proofs: list  # per level: SumcheckProof
    round_evaluations: list  # per level: GF2 (k,); host [pairs]
    output_claims: list  # glue.DevClaim; host Claim
    circuit_outputs: object  # GF2 (instances, 4): [n0, n1, d0, d1]; host [[pairs]]
    is_table: bool


@dataclasses.dataclass
class VerifierClaim:
    claims: list[Claim]
    numerators: list[ExtPair]
    denominators: list[ExtPair]


# ---------------------------------------------------------------------------
# circuit construction
# ---------------------------------------------------------------------------


def merge_columns(columns, const_chal: GF2, sep_chal: GF2) -> GF2:
    """den[..., i] = const + sum_k sep^k col_k[..., i]. Columns are base
    tensors of shape (..., L); the challenges are GF2 of shape (...), one
    pair per instance. A zero column adds nothing, which lets instances
    with fewer columns share one stacked call."""
    const = const_chal.reshape(*const_chal.shape, 1)
    sep = sep_chal.reshape(*sep_chal.shape, 1)
    acc = gf.ext_add(const, gf.ext_from_base(columns[0]))
    chal = sep
    for k, col in enumerate(columns[1:], start=1):
        acc = gf.ext_add(acc, gf.ext_mul_base(chal, col))
        if k + 1 < len(columns):
            chal = gf.ext_mul(chal, sep)
    return acc


def _halves(a: GF2):
    half = a.shape[-1] // 2
    return a[..., :half], a[..., half:]


def _frac_add(n1, d1, n2, d2):
    return gf.ext_add(gf.ext_mul(n1, d2), gf.ext_mul(n2, d1)), gf.ext_mul(d1, d2)


def _lookup_tree(denominator: GF2):
    """All layers of a lookup circuit along the last axis: numerators are
    -1 at the input layer (implicit), so nums aligns with dens[1:]."""
    d_lo, d_hi = _halves(denominator)
    n = gf.ext_sub(gf.ext_zeros((), d_lo.device), gf.ext_add(d_lo, d_hi))
    d = gf.ext_mul(d_lo, d_hi)
    nums, dens = [n], [denominator, d]
    while d.shape[-1] > 2:
        (n_lo, n_hi), (d_lo, d_hi) = _halves(n), _halves(d)
        n, d = _frac_add(n_lo, d_lo, n_hi, d_hi)
        nums.append(n)
        dens.append(d)
    return nums, dens


def _table_tree(numerator: GF2, denominator: GF2):
    nums, dens = [numerator], [denominator]
    n, d = numerator, denominator
    while d.shape[-1] > 2:
        (n_lo, n_hi), (d_lo, d_hi) = _halves(n), _halves(d)
        n, d = _frac_add(n_lo, d_lo, n_hi, d_hi)
        nums.append(n)
        dens.append(d)
    return nums, dens


class _Circuits:
    """The fraction trees of several equal-size instances, each layer a GF2
    (instances, width) array, input layer first."""

    def __init__(self, nums, dens, initial_lookup: bool):
        self.nums = nums  # lookup circuits: aligned with dens[1:]
        self.dens = dens
        self.initial_lookup = initial_lookup

    @property
    def num_instances(self) -> int:
        return self.dens[0].shape[0]

    @property
    def num_vars(self) -> int:
        """log2(input length) - 1: the number of GKR levels."""
        return self.dens[0].shape[1].bit_length() - 2

    def outputs(self) -> GF2:
        """(instances, 4): [n0, n1, d0, d1] of each final 2-element layer."""
        if self.initial_lookup and len(self.dens) == 1:
            raise AssertionError("lookup circuit too small")
        return gf.ext_concatenate([self.nums[-1], self.dens[-1]], dim=1)

    def level_rows(self, level: int):
        """(kind, rows) for the sumcheck of GKR level `level` (1 = the output
        layer's children): rows per instance [d_hi, d_lo] for the lookup's
        input layer ("initial_lookup"), else [n_lo, d_hi, n_hi, d_lo], in
        instance order, each a GF2 (2^level,) view of the tree's layer (no
        copy: the sumcheck stacks them)."""
        idx = len(self.dens) - 1 - level
        d_lo, d_hi = _halves(self.dens[idx])
        if self.initial_lookup and idx == 0:
            kind, parts = "initial_lookup", [d_hi, d_lo]
        else:
            num = self.nums[idx - 1] if self.initial_lookup else self.nums[idx]
            n_lo, n_hi = _halves(num)
            kind, parts = "generic", [n_lo, d_hi, n_hi, d_lo]
        return kind, [part[i] for i in range(self.num_instances) for part in parts]


def _on(challenge, device) -> GF2:
    """A challenge (a device GF2 () or a host pair) as a GF2 () on `device`."""
    return challenge if isinstance(challenge, GF2) else gf.ext_scalar(challenge, device)


def _make_circuits(instances, multiplicities, dt) -> _Circuits:
    """instances: [(columns, const_pair, sep_pair)] of one column length;
    multiplicities: one per instance for tables, else None."""
    length = instances[0][0][0].shape[0]
    assert all(c.shape[0] == length for cols, _, _ in instances for c in cols), (
        "the instances of one logup proof must share a column size"
    )
    zero = torch.zeros(length, dtype=torch.int64, device=dt.device)
    columns = [
        torch.stack([cols[k] if k < len(cols) else zero for cols, _, _ in instances])
        for k in range(max(len(cols) for cols, _, _ in instances))
    ]
    challenges = gf.ext_stack(
        [_on(c, dt.device) for _, c, _ in instances] + [_on(s, dt.device) for _, _, s in instances]
    )
    n = len(instances)
    den = merge_columns(columns, challenges[:n], challenges[n:])
    if multiplicities is None:
        nums, dens = _lookup_tree(den)
        return _Circuits(nums, dens, initial_lookup=True)
    nums, dens = _table_tree(gf.ext_from_base(torch.stack(list(multiplicities))), den)
    return _Circuits(nums, dens, initial_lookup=False)


# ---------------------------------------------------------------------------
# claim algebra (eager ops on (instances,)-sized device arrays)
# ---------------------------------------------------------------------------


def _lerp(bc: GF2, x: GF2, y: GF2) -> GF2:
    """x + bc (y - x)."""
    return gf.ext_add(x, gf.ext_mul(bc, gf.ext_sub(y, x)))


def _batched(terms: GF2, apow: GF2) -> GF2:
    """sum_i alpha^i terms[i], apow = (alpha^i)_i."""
    return gf.ext_sum_axis(gf.ext_mul(apow, terms), 0)


def _initial_claim(out_ext: GF2, bc, apow, lam) -> GF2:
    """sum_i alpha^i (e0 + bc(e1 - e0) + lam(e2 + bc(e3 - e2))) over the
    circuit outputs [n0, n1, d0, d1] of each instance."""
    e = [out_ext[:, k] for k in range(4)]
    return _batched(gf.ext_add(_lerp(bc, e[0], e[1]), gf.ext_mul(lam, _lerp(bc, e[2], e[3]))), apow)


def _next_claim(evals: GF2, bc, apow, lam) -> GF2:
    """Per instance evals [n_lo, d_hi, n_hi, d_lo]:
    sum_i alpha^i (e0 + bc(e2 - e0) + lam(e3 + bc(e1 - e3)))."""
    e = [evals[:, k] for k in range(4)]
    return _batched(gf.ext_add(_lerp(bc, e[0], e[2]), gf.ext_mul(lam, _lerp(bc, e[3], e[1]))), apow)


def _final_lookup_claim(evals: GF2, bc, apow) -> GF2:
    """Per instance evals [d_hi, d_lo]: sum_i alpha^i (e1 + bc(e0 - e1))."""
    return _batched(_lerp(bc, evals[:, 1], evals[:, 0]), apow)


def _level_coeffs(apow, lam, kind: str) -> GF2:
    """Product coefficients of one level: [a, a, a lam] for a generic
    instance, [-a, -a, a lam] for a lookup's input layer (a = alpha^i)."""
    a = apow
    al = gf.ext_mul(a, lam)
    if kind != "generic":
        a = GF2(gf.neg(a.a0), gf.neg(a.a1))
    return gf.ext_stack([a, a, al], dim=1).reshape(-1)


# ---------------------------------------------------------------------------
# prover
# ---------------------------------------------------------------------------


def _challenges(dt, prefix: bytes, pre=(), arr=None):
    """The (batching, alpha, lambda) triple in one sponge call, after
    absorbing `pre` and `arr`."""
    labels = tuple(label_chunks(prefix + s) for s in (b"_batching", b"_alpha", b"_lambda"))
    c = dt.step(pre=pre, arr=arr, labels=labels, k=3)
    return c[0], c[1], c[2]


def _level_vp(circuits: _Circuits, level: int, point: GF2):
    kind, rows = circuits.level_rows(level)
    vp = VirtualPolynomial.new(level)
    vp.add_mle(mle_mod.eq_table(point))
    base = vp.num_mles
    for row in rows:
        vp.add_mle(row)
    width = 4 if kind == "generic" else 2
    for i in range(circuits.num_instances):
        r = base + width * i
        if kind == "generic":  # rows n_lo, d_hi, n_hi, d_lo
            prods = [[0, r, r + 1], [0, r + 2, r + 3], [0, r + 3, r + 1]]
        else:  # rows d_hi, d_lo
            prods = [[0, r], [0, r + 1], [0, r + 1, r]]
        for f in prods:
            vp.add_product(None, f)
    return kind, vp


def _prove_circuits(circuits: _Circuits, base_mles, is_table: bool, dt) -> LogUpProof:
    num_instances = circuits.num_instances
    total_layers = circuits.num_vars
    out_ext = circuits.outputs()  # (I, 4)

    bc, alpha, lam = _challenges(dt, b"initial", pre=[num_instances], arr=out_ext.reshape(-1))
    apow = gf.ext_powers(alpha, num_instances)  # each level's alpha powers serve its claim and coefficients
    claim = _initial_claim(out_ext, bc, apow, lam)
    point = bc.reshape(1)
    sumcheck_proofs, round_evaluations = [], []

    for level in range(1, total_layers + 1):
        dt.append_exts(claim)
        kind, vp = _level_vp(circuits, level, point)
        vp.coeffs_dev = _level_coeffs(apow, lam, kind)
        out = prove_device(vp, dt)
        evals = out.final_evals[1:]  # without eq

        bc, alpha, lam = _challenges(dt, b"logup")
        apow = gf.ext_powers(alpha, num_instances)
        point = glue.concat_points([out.proof.point, bc])
        sumcheck_proofs.append(out.proof)
        per = evals.reshape(num_instances, -1)
        if level != total_layers or is_table:
            claim = _next_claim(per, bc, apow, lam)
        else:
            claim = _final_lookup_claim(per, bc, apow)
        round_evaluations.append(evals)

    circuits.nums = circuits.dens = None  # the tree is proved: free it before the columns' evaluations
    evals = _batch_evaluate(torch.stack(list(base_mles)), point)
    return LogUpProof(
        sumcheck_proofs=sumcheck_proofs,
        round_evaluations=round_evaluations,
        output_claims=[glue.DevClaim(point=point, eval=evals[i]) for i in range(len(base_mles))],
        circuit_outputs=out_ext,
        is_table=is_table,
    )


def _batch_evaluate(stacked, point: GF2) -> GF2:
    """Evaluate the rows of a (k, 2^n) base or GF2 array at one point."""
    out = stacked
    for i in range(point.shape[0]):
        lo, hi = out[:, 0::2], out[:, 1::2]
        out = mle_mod.fold(lo, hi, point[i])
    return gf.to_ext(out).reshape(-1)


def batch_prove_device(inp: LogUpInput, dt) -> LogUpProof:
    """One lookup or table input against a session transcript; device values."""
    k = inp.columns_per_instance
    instances = [
        (inp.column_evals[i * k : (i + 1) * k], inp.constant_challenge, inp.column_separation_challenge)
        for i in range(inp.num_instances)
    ]
    mults = [inp.multiplicities] if inp.is_table else None
    return _prove_circuits(_make_circuits(instances, mults, dt), inp.base_mles(), inp.is_table, dt)


def batch_prove_grouped(instances, dt) -> LogUpProof:
    """Many lookup instances of one column size, each with its own columns
    and challenges, in ONE GKR; claims flat in instance order.
    instances: [(columns, const_pair, sep_pair)]."""
    base = [c for cols, _, _ in instances for c in cols]
    return _prove_circuits(_make_circuits(instances, None, dt), base, False, dt)


def batch_prove_grouped_tables(instances, dt) -> LogUpProof:
    """Many tables of one size in ONE GKR; claims per instance
    [multiplicity, col_0, ...]. instances: [(columns, multiplicities,
    const_pair, sep_pair)]."""
    base = []
    for cols, mult, _, _ in instances:
        base += [mult] + list(cols)
    circuits = _make_circuits(
        [(cols, c, s) for cols, _, c, s in instances], [m for _, m, _, _ in instances], dt
    )
    return _prove_circuits(circuits, base, True, dt)


def batch_prove(inp: LogUpInput, transcript) -> LogUpProof:
    """Host-transcript API: proves on the columns' device, returns host
    values and advances `transcript`."""
    from ..transcript.session import DeviceTranscript

    dt = DeviceTranscript.from_host(transcript, inp.column_evals[0].device)
    return dt.materialize(batch_prove_device(inp, dt), transcript)


# ---------------------------------------------------------------------------
# verifier
# ---------------------------------------------------------------------------


def fractional_outputs(proof: LogUpProof) -> tuple[list[ExtPair], list[ExtPair]]:
    nums, dens = [], []
    for e in proof.circuit_outputs:
        nums.append(host.ext_add(host.ext_mul(e[0], e[3]), host.ext_mul(e[1], e[2])))
        dens.append(host.ext_mul(e[2], e[3]))
    return nums, dens


# the verifier's claim algebra: host weights of the evaluations


def _initial_weights(bc, alpha, lam, num_instances) -> list[ExtPair]:
    """sum_i alpha^i (e0 + bc(e1 - e0) + lam(e2 + bc(e3 - e2))) over the
    circuit outputs [n0, n1, d0, d1] of each instance, as weights."""
    one_bc = host.ext_sub(_ONE, bc)
    out = []
    for a in host.ext_powers(alpha, num_instances):
        al = host.ext_mul(a, lam)
        out += [host.ext_mul(a, one_bc), host.ext_mul(a, bc),
                host.ext_mul(al, one_bc), host.ext_mul(al, bc)]
    return out


def _next_weights(bc, alpha, lam, num_instances) -> list[ExtPair]:
    """Per instance evals [n_lo, d_hi, n_hi, d_lo]:
    sum_i alpha^i (e0 + bc(e2 - e0) + lam(e3 + bc(e1 - e3)))."""
    one_bc = host.ext_sub(_ONE, bc)
    out = []
    for a in host.ext_powers(alpha, num_instances):
        al = host.ext_mul(a, lam)
        out += [host.ext_mul(a, one_bc), host.ext_mul(al, bc),
                host.ext_mul(a, bc), host.ext_mul(al, one_bc)]
    return out


def _final_lookup_weights(bc, alpha, num_instances) -> list[ExtPair]:
    """Per instance evals [d_hi, d_lo]: sum_i alpha^i (e1 + bc(e0 - e1))."""
    one_bc = host.ext_sub(_ONE, bc)
    out = []
    for a in host.ext_powers(alpha, num_instances):
        out += [host.ext_mul(a, bc), host.ext_mul(a, one_bc)]
    return out


def _dot(weights, values) -> ExtPair:
    acc = _ZERO
    for w, v in zip(weights, values, strict=True):
        acc = host.ext_add(acc, host.ext_mul(w, v))
    return acc


def _level_expected(round_evals, eq_e, alpha, lam, num_instances) -> ExtPair:
    """What the level's sumcheck must end at: eq times each instance's
    n_lo d_hi + n_hi d_lo + lam d_lo d_hi (or -d_hi - d_lo + lam d_lo d_hi
    at a lookup's input layer), alpha-batched."""
    per = len(round_evals) // max(1, num_instances)
    assert per in (2, 4) and per * num_instances == len(round_evals), "logup level evaluations"
    acc = _ZERO
    for i, a in enumerate(host.ext_powers(alpha, num_instances)):
        e = round_evals[i * per : (i + 1) * per]
        if per == 4:  # [n_lo, d_hi, n_hi, d_lo]
            t = host.ext_add(host.ext_add(host.ext_mul(e[0], e[1]), host.ext_mul(e[2], e[3])),
                             host.ext_mul(lam, host.ext_mul(e[3], e[1])))
        else:  # [d_hi, d_lo]
            t = host.ext_add(host.ext_neg(host.ext_add(e[0], e[1])),
                             host.ext_mul(lam, host.ext_mul(e[0], e[1])))
        acc = host.ext_add(acc, host.ext_mul(a, t))
    return host.ext_mul(eq_e, acc)


def verify_logup_proof(
    proof: LogUpProof,
    num_instances: int,
    constant_challenge: ExtPair,
    column_separation_challenge: ExtPair,
    transcript,
    instance_specs=None,
    table_instance_specs=None,
) -> VerifierClaim:
    """instance_specs: [(k_cols, const, sep)] per instance for a proof of
    `batch_prove_grouped`; table_instance_specs: the same for
    `batch_prove_grouped_tables` (claims [multiplicity, col_0..] each).
    Either overrides num_instances and the uniform challenge pair."""
    specs = instance_specs if instance_specs is not None else table_instance_specs
    if specs is not None:
        num_instances = len(specs)
    transcript.append_field_element(num_instances)
    for evals in proof.circuit_outputs:
        transcript.append_field_element_exts(evals)
    numerators, denominators = fractional_outputs(proof)

    bc, alpha, lam = (transcript.get_and_append_challenge(b"initial" + s)
                      for s in (b"_batching", b"_alpha", b"_lambda"))
    outputs = [e for inst in proof.circuit_outputs for e in inst]
    current_claim = _dot(_initial_weights(bc, alpha, lam, len(proof.circuit_outputs)), outputs)
    sumcheck_point = [bc]

    assert len(proof.sumcheck_proofs) == len(proof.round_evaluations), "logup level count"
    for i, (sc_proof, round_evals) in enumerate(zip(proof.sumcheck_proofs, proof.round_evaluations)):
        transcript.append_field_element_ext(current_claim)
        level = i + 1
        eq_e = host.ext_eq_eval(sumcheck_point, sc_proof.point)
        subclaim = sumcheck_verify(current_claim, sc_proof.round_messages, level, 3, transcript)
        bc, alpha_next, lam_next = (transcript.get_and_append_challenge(b"logup" + s)
                                    for s in (b"_batching", b"_alpha", b"_lambda"))
        if _level_expected(round_evals, eq_e, alpha, lam, num_instances) != subclaim.expected_evaluation:
            raise AssertionError(f"logup level {i}: recomputed sumcheck claim mismatch")
        if len(round_evals) // num_instances == 4:
            weights = _next_weights(bc, alpha_next, lam_next, num_instances)
        else:
            weights = _final_lookup_weights(bc, alpha_next, num_instances)
        current_claim = _dot(weights, round_evals)
        alpha, lam = alpha_next, lam_next
        sumcheck_point = list(subclaim.point) + [bc]

    if table_instance_specs is not None:
        calculated = _calculate_final_eval_grouped_tables(proof, table_instance_specs, alpha, lam)
    elif instance_specs is not None:
        calculated = _calculate_final_eval_grouped(proof, instance_specs, alpha)
    else:
        calculated = _calculate_final_eval(
            proof, constant_challenge, column_separation_challenge, alpha, lam, num_instances
        )
    if calculated != current_claim:
        raise AssertionError("logup final column-claim check failed")
    return VerifierClaim(
        claims=list(proof.output_claims), numerators=numerators, denominators=denominators
    )


def _merged(const_c, sep_c, claims) -> ExtPair:
    """const + sum_k sep^k eval_k."""
    merged, csc = const_c, _ONE
    for cl in claims:
        merged = host.ext_add(merged, host.ext_mul(cl.eval, csc))
        csc = host.ext_mul(csc, sep_c)
    return merged


def _calculate_final_eval_grouped(proof: LogUpProof, instance_specs, alpha) -> ExtPair:
    """Grouped lookups: instance i has its own (k_i, const_i, sep_i)."""
    acc, off = _ZERO, 0
    for a, (k, const_c, sep_c) in zip(host.ext_powers(alpha, len(instance_specs)), instance_specs):
        acc = host.ext_add(acc, host.ext_mul(_merged(const_c, sep_c, proof.output_claims[off : off + k]), a))
        off += k
    return acc


def _calculate_final_eval_grouped_tables(proof: LogUpProof, table_instance_specs, alpha, lam) -> ExtPair:
    """Grouped tables: instance i adds alpha^i (mult_i + lam merged_i)."""
    acc, off = _ZERO, 0
    for a, (k, const_c, sep_c) in zip(host.ext_powers(alpha, len(table_instance_specs)), table_instance_specs):
        merged = _merged(const_c, sep_c, proof.output_claims[off + 1 : off + 1 + k])
        term = host.ext_add(proof.output_claims[off].eval, host.ext_mul(lam, merged))
        acc = host.ext_add(acc, host.ext_mul(term, a))
        off += 1 + k
    return acc


def _calculate_final_eval(
    proof: LogUpProof, constant_challenge, column_separation_challenge, alpha, lam, num_instances
) -> ExtPair:
    if not proof.is_table:
        per = len(proof.output_claims) // num_instances
        specs = [(per, constant_challenge, column_separation_challenge)] * num_instances
        return _calculate_final_eval_grouped(proof, specs, alpha)
    merged = _merged(constant_challenge, column_separation_challenge, proof.output_claims[1:])
    return host.ext_add(proof.output_claims[0].eval, host.ext_mul(lam, merged))
