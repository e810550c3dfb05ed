"""Model verifier, as in the JAX package's `zkml/iop/verifier.py`.

Mirrors the prover's transcript: absorb the context, re-derive the table
challenges, verify the consolidated lookup proofs (their layout taken from
the context), derive output claims, verify each layer backwards (merging
the claims of a wire with several consumers as the prover did), verify
the table proofs and their column evaluations, check input claims against
the model input MLEs, verify the batched commitment opening, and finally
check that all lookup fractions sum to zero. Host code, apart from the
Merkle path walk, which runs on `device`.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import device as device_mod
from ...fields import gf, host
from ...lookup import logup
from ...lookup.logup import Claim
from ..commit import CommitmentVerifier, same_poly_verify
from ..lookup_context import ChallengeStorage
from .prover import claims_for_node


@dataclasses.dataclass
class IO:
    inputs: list  # Tensors
    outputs: list  # Tensors


class Verifier:
    def __init__(self, ctx, transcript, io: IO | None = None):
        self.ctx = ctx
        self.transcript = transcript
        self.commit_verifier = CommitmentVerifier(ctx.commitment_ctx)
        self.challenge_storage = None
        self.shared_logup_claims = {}
        self.io = io

    def public_inputs_for(self, node_id) -> torch.Tensor:
        """The public model input feeding this node (flat, on the host)."""
        edge = self.ctx.steps_info[node_id].inputs[0]
        assert edge.node is None, "node input is not a model input"
        return self.io.inputs[edge.index].data.reshape(-1).cpu()


def _host_field(t):
    return gf.to_u64(t.to_field())


def _verify_shared_logup(ctx, proof, v, transcript, numerators, denominators):
    """The consolidated lookup proofs. Each instance's (columns, challenges)
    come from the context's layout; the proof only orders the instances,
    and every expected instance must be proved exactly once."""
    expected = {}
    for nid in ctx.forward_order():
        op = ctx.steps_info[nid].op
        if getattr(op, "shared_logup", False):
            for wi, (n_inst, k, tt) in enumerate(op.shared_lookup_layout()):
                expected[(nid, wi)] = [n_inst, k, tt]
    for group in proof.shared_logup:
        specs = []
        for nid, wi, j, k_claimed in group.instances:
            exp = expected.get((nid, wi))
            assert exp is not None, f"unexpected shared-logup instance {nid}/{wi}"
            n_inst, k, tt = exp
            assert k == k_claimed and 0 <= j < n_inst, "shared-logup layout"
            specs.append((k, *v.challenge_storage.get(tt.name())))
        out = logup.verify_logup_proof(group.proof, 0, (0, 0), (0, 0), transcript, instance_specs=specs)
        off = 0
        for nid, wi, j, k in group.instances:
            bucket = v.shared_logup_claims.setdefault((nid, wi), [])
            assert j * k == len(bucket), "shared-logup instance order"
            bucket.extend(out.claims[off : off + k])
            expected[(nid, wi)][0] -= 1
            off += k
        numerators.extend(out.numerators)
        denominators.extend(out.denominators)
    for key, (n_left, _, _) in expected.items():
        assert n_left == 0, f"shared-logup instance count mismatch at {key}"


def _verify_tables(ctx, proof, v, transcript):
    """The table proofs: one a table size, ascending, tables in sorted order
    (re-derived from the context), each table's column evaluations checked
    against the verifier's own."""
    exp_groups: dict[int, list] = {}
    for tt in ctx.lookup:
        exp_groups.setdefault(1 << tt.multiplicity_poly_vars(), []).append(tt)
    exp_list = [exp_groups[s] for s in sorted(exp_groups)]
    assert len(proof.table_proofs) == len(exp_list), "table proof count"
    for tp, tts in zip(proof.table_proofs, exp_list):
        assert list(tp.table_types) == tts, "table group mismatch"
        assert len(tp.multiplicity_commits) == len(tts), "table commitment count"
        if len(tts) == 1:
            const_c, sep_c = v.challenge_storage.get(tts[0].name())
            claims = logup.verify_logup_proof(tp.lookup, 1, const_c, sep_c, transcript)
        else:
            specs = [(tt.num_columns(), *v.challenge_storage.get(tt.name())) for tt in tts]
            claims = logup.verify_logup_proof(
                tp.lookup, 0, (0, 0), (0, 0), transcript, table_instance_specs=specs
            )
        off = 0
        for i, tt in enumerate(tts):
            sl = claims.claims[off : off + 1 + tt.num_columns()]
            v.commit_verifier.add_witness_claim(tp.multiplicity_commits[i], sl[0])
            table_claims = tt.table_claims(sl)
            for claim in table_claims:
                v.commit_verifier.add_table_claim(tt, claim)
            expected_cols = tt.evaluate_table_columns(sl[0].point)
            col_claims = sl[1:]
            assert len(expected_cols) == len(col_claims) - len(table_claims)
            for cl, exp in zip(col_claims, expected_cols):
                assert cl.eval == exp, f"table column eval mismatch for {tt.name()}"
            off += 1 + tt.num_columns()


def verify(ctx, proof, io: IO, transcript, device="cuda"):
    """Raises AssertionError if `proof` does not prove `io` under `ctx`."""
    dev = device_mod.resolve(device)
    v = Verifier(ctx, transcript, io)
    ctx.write_to_transcript(transcript)
    if ctx.lookup:
        v.challenge_storage = ChallengeStorage.initialise(ctx.lookup, transcript)
    numerators, denominators = [], []
    _verify_shared_logup(ctx, proof, v, transcript, numerators, denominators)
    for tp in proof.table_proofs:
        nums, dens = logup.fractional_outputs(tp.lookup)
        numerators.extend(nums)
        denominators.extend(dens)

    out_claims = []
    for out in io.outputs:
        r = [transcript.read_challenge() for _ in range(out.num_vars())]
        out_claims.append(Claim(point=r, eval=host.mle_eval_v(_host_field(out), r)))

    claims_by_layer = {}
    out_nodes = ctx.model.output_nodes()

    def merger(nid, wire, cands):
        sp = proof.merges[(nid, wire)]
        return same_poly_verify(sp, cands, len(cands[0].point), transcript)

    for nid in ctx.backward_order():
        node_ctx = ctx.steps_info[nid]
        claims = claims_for_node(ctx.model, nid, claims_by_layer, out_claims, out_nodes, merger)
        if node_ctx.ctx.is_provable:
            claims = node_ctx.ctx.verify(proof.steps[nid], claims, v)
        claims_by_layer[nid] = claims

    _verify_tables(ctx, proof, v, transcript)

    for nid in ctx.forward_order():
        for slot, edge in enumerate(ctx.steps_info[nid].inputs):
            if edge.node is None:
                claim = claims_by_layer[nid][slot]
                y = host.mle_eval_v(_host_field(io.inputs[edge.index]), claim.point)
                assert y == claim.eval, "input claim mismatch"

    v.commit_verifier.verify(proof.commit, transcript, dev)

    # all lookup fractions together must sum to zero
    final_num, final_den = (0, 0), (1, 0)
    for num, den in zip(numerators, denominators):
        final_num = host.ext_add(host.ext_mul(final_num, den), host.ext_mul(num, final_den))
        final_den = host.ext_mul(final_den, den)
    assert final_num == (0, 0), "global lookup numerator non-zero"
    assert final_den != (0, 0), "global lookup denominator zero"
