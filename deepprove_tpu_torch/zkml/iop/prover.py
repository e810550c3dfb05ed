"""Model prover: the backward claim loop, as in the JAX package's
`zkml/iop/prover.py`.

Flow: absorb the context; commit the lookup witnesses and multiplicities
and derive the table challenges; prove every node's lookups in one logup
proof per column size; derive output claims from Fiat-Shamir; walk the DAG
backwards proving each node, merging the claims on an output wire that
feeds several consumers (a residual) into one with a same-poly sumcheck;
prove the tables, one logup proof per table size; then emit one batched
Basefold opening for every accumulated claim.
Claims and proof values stay on the device; the proof is lowered to host
ints in one pull at the end.
"""

from __future__ import annotations

import dataclasses

from ... import device as device_mod
from ... import glue
from ...lookup import logup
from ...poly import mle as mle_mod
from ...transcript.session import DeviceTranscript
from ..commit import CommitmentProver, same_poly_prove_device
from ..lookup_context import generate_lookup_witnesses, table_columns_padded
from ..model import InferenceTrace


@dataclasses.dataclass
class TableProof:
    """One logup proof of every table of one size; `table_types` and
    `multiplicity_commits` are in instance order (sorted table order), the
    claims per instance [multiplicity, col_0, ...]."""

    table_types: list
    multiplicity_commits: list  # BasefoldCommitment per table
    lookup: object  # LogUpProof


@dataclasses.dataclass
class SharedLogUpGroup:
    """One logup proof of many nodes' lookup instances of one column size.
    `instances` lists (node_id, witness_idx, instance_idx, cols_per_instance)
    in alpha-batching order; the verifier takes each instance's challenges
    from the context's table layout, never from the proof."""

    instances: list
    proof: object  # LogUpProof


@dataclasses.dataclass
class Proof:
    steps: dict  # NodeId -> layer proof
    table_proofs: list = dataclasses.field(default_factory=list)
    commit: dict = dataclasses.field(default_factory=dict)  # {"batch": ..., "trivial": [...]}
    # fan-out claim merges: (node_id, wire) -> SamePolyProof
    merges: dict = dataclasses.field(default_factory=dict)
    # the consolidated node-lookup proofs, by column size (ascending)
    shared_logup: list = dataclasses.field(default_factory=list)


class Prover:
    def __init__(self, ctx, transcript, device="cuda"):
        self.device = device_mod.resolve(device)
        if self.device != ctx.device:
            raise ValueError(f"context lives on {ctx.device}, prover asked for {self.device}")
        self.ctx = ctx
        self.transcript = transcript
        self.commit_prover = CommitmentProver(ctx.commitment_ctx)
        self.proofs = {}
        self.challenge_storage = None
        self.lookup_witness = {}
        self.table_witness = []
        self.shared_logup_claims = {}
        self.dt = None

    def push_proof(self, node_id, proof):
        self.proofs[node_id] = proof

    def lookup_witnesses_for(self, node_id):
        return self.lookup_witness.pop(node_id)

    def shared_claims_for(self, node_id, wit_idx):
        """A witness's column claims from the consolidated lookup proof (all
        at that group's point, in column order)."""
        return self.shared_logup_claims[(node_id, wit_idx)]

    def _prove_shared_logup(self) -> list:
        """One grouped logup proof per column size, ascending; instances by
        node id, witness index, then instance."""
        groups = []
        by_size = {}
        for nid in sorted(self.lookup_witness):
            if not getattr(self.ctx.steps_info[nid].op, "shared_logup", False):
                continue
            for wi, wit in enumerate(self.lookup_witness[nid]):
                by_size.setdefault(int(wit.column_evals[0].shape[0]), []).append((nid, wi, wit))
        for size in sorted(by_size):
            instances, index = [], []
            for nid, wi, wit in by_size[size]:
                const_c, sep_c = self.challenge_storage.get(wit.table_type.name())
                k = wit.columns_per_instance
                for j in range(len(wit.column_evals) // k):
                    instances.append((wit.column_evals[j * k : (j + 1) * k], const_c, sep_c))
                    index.append((nid, wi, j, k))
            proof = logup.batch_prove_grouped(instances, self.dt)
            off = 0
            for nid, wi, j, k in index:
                self.shared_logup_claims.setdefault((nid, wi), []).extend(
                    proof.output_claims[off : off + k]
                )
                off += k
            groups.append(SharedLogUpGroup(instances=index, proof=proof))
        return groups

    def _prove_tables(self) -> list:
        """One logup proof per table size, ascending: a lone table alone, equal
        sizes grouped in sorted table order. A table's columns are made when
        its group is proved and dropped after."""
        groups = {}
        for tw in self.table_witness:
            groups.setdefault(int(tw.multiplicities.shape[0]), []).append(tw)
        self.table_witness = []
        table_proofs = []
        for size in sorted(groups):
            tws = groups.pop(size)
            if len(tws) == 1:
                proof = logup.batch_prove_device(tws[0].get_logup_input(self.challenge_storage), self.dt)
            else:
                instances = [
                    (table_columns_padded(tw.table_type, self.device), tw.multiplicities,
                     *self.challenge_storage.get(tw.table_type.name()))
                    for tw in tws
                ]
                proof = logup.batch_prove_grouped_tables(instances, self.dt)
                del instances
            off, commits = 0, []
            for tw in tws:
                n_cols = tw.table_type.num_columns()
                claims = proof.output_claims[off : off + 1 + n_cols]
                comm, poly = tw.commits[0]
                self.commit_prover.add_witness_claim((comm, poly), claims[0])
                for claim in tw.table_type.table_claims(claims):
                    self.commit_prover.add_table_claim(tw.table_type, claim)
                commits.append(comm.commitment)
                off += 1 + n_cols
            table_proofs.append(
                TableProof(table_types=[tw.table_type for tw in tws], multiplicity_commits=commits,
                           lookup=proof)
            )
        return table_proofs

    def prove(self, trace: InferenceTrace) -> Proof:
        self.ctx.write_to_transcript(self.transcript)
        self.dt = DeviceTranscript.from_host(self.transcript, self.device)
        if self.ctx.lookup:
            storage, witnesses, table_witnesses = generate_lookup_witnesses(trace, self.ctx, self.dt)
            self.challenge_storage = storage
            self.lookup_witness = witnesses
            self.table_witness = table_witnesses
        shared_logup = self._prove_shared_logup()

        out_claims = []
        for out in trace.outputs:
            r = self.dt.read_challenges(out.num_vars())
            out_claims.append(glue.DevClaim(point=r, eval=mle_mod.evaluate(out.to_field(), r)))

        claims_by_layer: dict[int, list] = {}
        out_nodes = self.ctx.model.output_nodes()
        merges = {}

        def merger(nid, wire, cands):
            poly = trace.steps[nid].outputs[wire].to_field()
            merges[(nid, wire)] = same_poly_prove_device(poly, cands, self.dt)
            return merges[(nid, wire)].extract_claim()

        for nid in self.ctx.backward_order():
            node_ctx = self.ctx.steps_info[nid]
            claims = claims_for_node(self.ctx.model, nid, claims_by_layer, out_claims, out_nodes, merger)
            if node_ctx.op.is_provable:
                claims = node_ctx.op.prove(nid, node_ctx.ctx, claims, trace.steps[nid], self)
            claims_by_layer[nid] = claims

        table_proofs = self._prove_tables()
        proof = Proof(
            steps=self.proofs, table_proofs=table_proofs,
            commit=self.commit_prover.prove(self.dt), merges=merges, shared_logup=shared_logup,
        )
        return self.dt.materialize(proof, self.transcript)


def claims_for_node(model, nid, claims_by_layer, out_claims, out_nodes, merger):
    """One claim per output wire: the model-output claim (wire 0 of an
    output node), then each consumer's claim in (consumer id, slot) order.
    Where a wire has several, `merger(nid, wire, claims)` merges them into
    one (the same-poly sumcheck, at this node's place in the backward
    order, keyed (node, wire))."""
    claims = []
    for w in range(model.num_outputs(nid)):
        cands = []
        if nid in out_nodes and w == 0:
            cands.append(out_claims[out_nodes.index(nid)])
        for cid, slot in model.consumers_of_wire(nid, w):
            cands.append(claims_by_layer[cid][slot])
        assert cands, f"no claims for node {nid} output {w}"
        claims.append(cands[0] if len(cands) == 1 else merger(nid, w, cands))
    return claims
