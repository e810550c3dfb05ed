"""Claim accumulation -> batched Basefold opening.

As in the JAX package's `zkml/commit.py`: `CommitmentContext` commits every
model weight poly (and committed table columns) at setup and the lookup
witness columns at prove time; `CommitmentProver` collects claims during the
backward proving pass, splits trivial (<= basecode vars) from batched, and
emits one batch opening; `CommitmentVerifier` mirrors it. `same_poly_*`
binds k claims on one polynomial into one with a beta-RLC sumcheck.
"""

from __future__ import annotations

import dataclasses

from .. import glue
from ..fields import gf, host
from ..lookup.logup import Claim
from ..pcs import basefold
from ..poly import mle as mle_mod
from ..sumcheck import VirtualPolynomial, prove_device
from ..sumcheck import verify as sumcheck_verify

ExtPair = tuple[int, int]


class CommitmentContext:
    """Params + commitments for the model polys and committed table columns."""

    def __init__(self, max_poly_len: int, model_polys, table_types=(), device="cpu", **pcs_kw):
        """model_polys: {node_id: {poly_id: field tensor}} (little-endian) on
        `device`, where the committed table columns are made too."""
        for polys in model_polys.values():
            for p in polys.values():
                max_poly_len = max(max_poly_len, p.shape[0])
        self.params = basefold.setup(max(1, (max_poly_len - 1).bit_length()), **pcs_kw)
        keys, polys = [], []
        for node_id in sorted(model_polys):
            for pid, poly in sorted(model_polys[node_id].items()):
                keys.append((node_id, pid))
                polys.append(poly)
        table_cols = {tt: tt.committed_columns(device) for tt in sorted(table_types)}
        table_cols = {tt: cols for tt, cols in table_cols.items() if cols is not None}
        comms = iter(basefold.commit_many(self.params, polys + list(table_cols.values())))
        self.model_comms = {}
        for (node_id, pid), poly in zip(keys, polys):
            self.model_comms.setdefault(node_id, {})[pid] = (next(comms), poly)
        self.table_comms = {tt: (next(comms), cols) for tt, cols in table_cols.items()}

    @property
    def trivial_num_vars(self) -> int:
        return self.params.basecode_msg_size_log

    def write_to_transcript(self, transcript):
        for node_id in sorted(self.model_comms):
            for pid in sorted(self.model_comms[node_id]):
                comm, _ = self.model_comms[node_id][pid]
                basefold.write_commitment(comm.commitment, transcript)
        for tt in sorted(self.table_comms):
            basefold.write_commitment(self.table_comms[tt][0].commitment, transcript)

    def commit_many(self, evals_list) -> list:
        """A prove's witness commitments at the context's parameters, the
        trees of equal-size polynomials built together; their roots stay on
        the device until the proof is materialized (no read in the prove)."""
        return basefold.commit_many(self.params, evals_list, host_roots=False)


@dataclasses.dataclass
class _ProverClaim:
    comm: object  # CommitmentWithWitness
    poly: object
    claim: object  # glue.DevClaim


class CommitmentProver:
    def __init__(self, ctx: CommitmentContext):
        self.ctx = ctx
        self.claims: list[_ProverClaim] = []
        self.trivial: list[_ProverClaim] = []

    def add_witness_claim(self, comm_with_poly, claim):
        comm, poly = comm_with_poly
        entry = _ProverClaim(comm, poly, claim)
        if poly.shape[0].bit_length() - 1 <= self.ctx.trivial_num_vars:
            self.trivial.append(entry)
        else:
            self.claims.append(entry)

    def add_common_claims(self, node_id: int, claims: dict):
        """Model-poly claims keyed by poly id, added in sorted-id order."""
        for pid, (comm, poly) in self.ctx.model_comms[node_id].items():
            self.add_witness_claim((comm, poly), claims[pid])

    def add_table_claim(self, table_type, claim):
        self.add_witness_claim(self.ctx.table_comms[table_type], claim)

    def prove(self, dt):
        """Open all accumulated claims against the session transcript."""
        params = self.ctx.params
        trivial = [basefold.open_session(params, c.comm, c.claim.point, dt) for c in self.trivial]
        batch = None
        if self.claims:
            batch = basefold.batch_open_session(
                params,
                [c.poly for c in self.claims],
                [c.comm for c in self.claims],
                [c.claim.point for c in self.claims],
                [
                    basefold.BatchEvaluation(poly=i, point=i, value=c.claim.eval)
                    for i, c in enumerate(self.claims)
                ],
                dt,
            )
        return {"batch": batch, "trivial": trivial}


@dataclasses.dataclass
class _VerifierClaim:
    commitment: object  # BasefoldCommitment
    claim: Claim


class CommitmentVerifier:
    def __init__(self, ctx: CommitmentContext):
        self.ctx = ctx
        self.claims: list[_VerifierClaim] = []
        self.trivial: list[_VerifierClaim] = []

    def add_witness_claim(self, commitment, claim: Claim):
        entry = _VerifierClaim(commitment, claim)
        if commitment.num_vars <= self.ctx.trivial_num_vars:
            self.trivial.append(entry)
        else:
            self.claims.append(entry)

    def add_common_claims(self, node_id: int, claims: dict):
        for pid, (comm, _) in self.ctx.model_comms[node_id].items():
            self.add_witness_claim(comm.commitment, claims[pid])

    def add_table_claim(self, table_type, claim: Claim):
        self.add_witness_claim(self.ctx.table_comms[table_type][0].commitment, claim)

    def verify(self, proof, transcript, device):
        params = self.ctx.params
        assert len(proof["trivial"]) == len(self.trivial), "trivial proof count"
        for tp, tc in zip(proof["trivial"], self.trivial):
            basefold.verify(
                params, tc.commitment, tc.claim.point, tc.claim.eval, tp, transcript, device
            )
        if not self.claims:
            assert proof["batch"] is None
            return
        basefold.batch_verify(
            params,
            [c.commitment for c in self.claims],
            [c.claim.point for c in self.claims],
            [
                basefold.BatchEvaluation(poly=i, point=i, value=c.claim.eval)
                for i, c in enumerate(self.claims)
            ],
            proof["batch"],
            transcript,
            device,
        )


# ---------------------------------------------------------------------------
# same-poly claim aggregation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SamePolyProof:
    sumcheck: object  # SumcheckProof
    evals: object  # GF2 (2,): [beta eval, poly eval]; host [pairs]

    def extract_claim(self) -> glue.DevClaim:
        """The merged claim on the polynomial (prover side, device values)."""
        return glue.DevClaim(point=self.sumcheck.point, eval=self.evals[1])


def same_poly_prove_device(poly, claims, dt) -> SamePolyProof:
    """sum_x beta(x) f(x) = sum_i a_i y_i for fresh challenges a_i, with
    beta = sum_i a_i eq(x, r_i) (claims: DevClaims on `poly`)."""
    chals = dt.read_challenges(len(claims))
    beta = None
    for i, c in enumerate(claims):
        t = mle_mod.eq_table(c.point, scale=chals[i])
        beta = t if beta is None else gf.ext_add(beta, t)
    vp = VirtualPolynomial.new(poly.shape[0].bit_length() - 1)
    vp.add_product((1, 0), [vp.add_mle(beta), vp.add_mle(poly)])
    out = prove_device(vp, dt)
    return SamePolyProof(sumcheck=out.proof, evals=out.final_evals)


def same_poly_verify(proof: SamePolyProof, claims: list[Claim], num_vars: int, transcript) -> Claim:
    challenges = [transcript.read_challenge() for _ in range(len(claims))]
    y = (0, 0)
    for a, c in zip(challenges, claims):
        y = host.ext_add(y, host.ext_mul(a, c.eval))
    sub = sumcheck_verify(y, proof.sumcheck.round_messages, num_vars, 2, transcript)
    beta_eval = (0, 0)
    for a, c in zip(challenges, claims):
        beta_eval = host.ext_add(beta_eval, host.ext_mul(a, host.ext_eq_eval(c.point, sub.point)))
    got = host.ext_mul(beta_eval, proof.evals[1])
    assert got == sub.expected_evaluation, "same-poly final check"
    return Claim(point=list(sub.point), eval=proof.evals[1])

