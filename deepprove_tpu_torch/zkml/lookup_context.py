"""Lookup tables and witness generation, as in the JAX package's
`zkml/lookup_context.py`.

Each table has (a) a merged Element column `in + 2^32 out` against which
the looked-up values are counted and (b) its base-field columns, which the
table proof proves and the verifier evaluates in closed form. Tables sort
by kind, then parameters. This slice of the port has the tables of the
Dense-MLP path: relu, range and clamping; the others arrive with the
transformer slice.
"""

from __future__ import annotations

import dataclasses
from functools import total_ordering

import numpy as np
import torch

from ..fields import gf, host
from . import quantization as Q

COLUMN_SEPARATOR = 1 << 32
ExtPair = tuple[int, int]

_ORDER = {
    "relu": 0, "gelu": 1, "range": 2, "clamping": 3,
    "softmax": 4, "error": 5, "zero": 6, "inv_sqrt": 7,
}
_PORTED = ("relu", "range", "clamping")


def _host_field(x: np.ndarray) -> np.ndarray:
    """int64 Elements -> canonical Goldilocks u64 (negatives wrap mod p)."""
    a = np.asarray(x, dtype=np.int64)
    return np.where(a < 0, np.uint64(host.P) - (-a).astype(np.uint64), a.astype(np.uint64))


@total_ordering
@dataclasses.dataclass(frozen=True)
class TableType:
    """kind in {relu, range, clamping} (the JAX package's other kinds,
    gelu, softmax, error, zero and inv_sqrt, sort here but raise);
    params is a kind-specific tuple (the clamping bit size)."""

    kind: str
    params: tuple = ()

    def __lt__(self, other):
        return (_ORDER[self.kind], self.params) < (_ORDER[other.kind], other.params)

    def _check(self):
        if self.kind not in _PORTED:
            raise NotImplementedError(
                f"lookup table {self.kind!r} arrives with the transformer slice of the port"
            )

    def name(self) -> str:
        self._check()
        if self.kind == "clamping":
            return f"Clamping: {self.params[0]}"
        return {"relu": "Relu", "range": "Range"}[self.kind]

    def table_columns(self) -> tuple[np.ndarray, list[np.ndarray]]:
        """(merged Element column, [base-field u64 columns])."""
        self._check()
        if self.kind == "relu":
            i = np.arange(Q.MIN - 1, Q.MAX + 1, dtype=np.int64)
            out = np.maximum(i, 0)
            return i + out * COLUMN_SEPARATOR, [_host_field(i), _host_field(out)]
        if self.kind == "range":
            i = np.arange(0, 1 << Q.BIT_LEN, dtype=np.int64)
            return i.copy(), [_host_field(i)]
        mx = 1 << (self.params[0] - 1)
        i = np.arange(-mx, mx, dtype=np.int64)
        out = np.clip(i, Q.MIN, Q.MAX)
        return i + out * COLUMN_SEPARATOR, [_host_field(i), _host_field(out)]

    def num_columns(self) -> int:
        self._check()
        return 1 if self.kind == "range" else 2

    def multiplicity_poly_vars(self) -> int:
        self._check()
        return self.params[0] if self.kind == "clamping" else Q.BIT_LEN

    def committed_columns(self):
        """Columns the PCS must commit: none of relu, range, clamping."""
        self._check()
        return None

    def generate_challenge(self, transcript):
        """The table's column-separation challenge: a host pair from a host
        transcript, a device GF2 () from a session."""
        self._check()
        if self.kind == "range":
            dev = getattr(transcript, "device", None)
            return (1, 0) if dev is None else gf.ext_ones((), dev)
        return transcript.get_and_append_challenge(b"Relu" if self.kind == "relu" else b"Clamping")

    def evaluate_table_columns(self, point: list[ExtPair]) -> list[ExtPair]:
        """The verifier's evaluations of the table columns at `point`."""
        self._check()

        def ident(pt):
            acc = (0, 0)
            for i, p in enumerate(pt):
                acc = host.ext_add(acc, host.ext_mul(p, ((1 << i) % host.P, 0)))
            return acc

        if self.kind == "range":
            assert len(point) == Q.BIT_LEN
            return [ident(point)]
        if self.kind == "relu":
            assert len(point) == Q.BIT_LEN
            first = host.ext_sub(ident(point), ((1 << (Q.BIT_LEN - 1)) % host.P, 0))
            top = point[-1]
            second = (0, 0)
            for i, p in enumerate(point[:-1]):
                second = host.ext_add(second, host.ext_mul(host.ext_mul(p, ((1 << i) % host.P, 0)), top))
            return [first, second]
        size = self.params[0]
        assert len(point) == size
        first = host.ext_sub(ident(point), ((1 << (size - 1)) % host.P, 0))
        # the output column has no closed form: evaluate its MLE on the host
        _, cols = self.table_columns()
        return [first, host.mle_eval_v(cols[1], point)]

    def table_claims(self, claims: list) -> list:
        """Claims that go to the commitment accumulator: none here."""
        self._check()
        return []


@dataclasses.dataclass
class ChallengeStorage:
    constant_challenge: ExtPair
    challenge_map: dict  # table name -> ExtPair

    @staticmethod
    def initialise(table_types, transcript) -> "ChallengeStorage":
        """b"table_constant", then each table's challenge in sorted order."""
        constant = transcript.get_and_append_challenge(b"table_constant")
        cmap = {tt.name(): tt.generate_challenge(transcript) for tt in sorted(table_types)}
        return ChallengeStorage(constant_challenge=constant, challenge_map=cmap)

    def get(self, name: str) -> tuple[ExtPair, ExtPair]:
        return self.constant_challenge, self.challenge_map[name]


@dataclasses.dataclass
class LogUpWitness:
    """Polynomials to commit and column evaluations (base tensors on the
    device). `generate_lookup_witnesses` commits the polys of every witness
    at once and fills in `commits`."""

    polys: list
    column_evals: list
    columns_per_instance: int
    table_type: TableType
    multiplicities: torch.Tensor | None = None  # table witnesses only
    commits: list | None = None  # [(CommitmentWithWitness, poly)], in `polys` order

    def get_logup_input(self, storage: ChallengeStorage):
        from ..lookup import logup

        const_c, sep_c = storage.get(self.table_type.name())
        if self.multiplicities is not None:
            return logup.LogUpInput.new_table(self.column_evals, self.multiplicities, const_c, sep_c)
        return logup.LogUpInput.new_lookup(self.column_evals, const_c, sep_c, self.columns_per_instance)


def count_elements(values: torch.Tensor) -> dict:
    """{value: occurrences} of an int64 tensor (one device-to-host copy)."""
    vals, counts = torch.unique(values.reshape(-1), return_counts=True)
    return dict(zip(vals.tolist(), counts.tolist()))


def generate_lookup_witnesses(trace, ctx, transcript):
    """Walk the trace forward collecting each node's lookup witnesses and
    element counts, build every table's multiplicities, commit the polys of
    all the witnesses together (`commit_many`), then derive the
    challenge storage from `transcript` (a session, on the prover's side).
    Returns (storage, {node id: [LogUpWitness]}, [table LogUpWitness])."""
    element_count: dict = {}
    logup_witnesses: dict = {}
    for node_id in ctx.forward_order():
        op = ctx.steps_info[node_id].op
        if not hasattr(op, "gen_lookup_witness"):
            continue
        witnesses, counts = op.gen_lookup_witness(node_id, ctx, trace.steps[node_id])
        logup_witnesses[node_id] = witnesses
        for tt, cmap in counts.items():
            agg = element_count.setdefault(tt, {})
            for k, v in cmap.items():
                agg[k] = agg.get(k, 0) + v

    table_witnesses = []
    for tt in sorted(element_count):
        counts = element_count[tt]
        merged, cols = tt.table_columns()
        n = len(merged)
        np2 = 1 << max(0, (n - 1).bit_length())
        if np2 != n:
            # a table that is not a power of two is padded by repeating rows;
            # each row's multiplicity is count / repetitions in the field
            pad_idx = np.arange(np2) % n
            merged = merged[pad_idx]
            cols = [c[pad_idx] for c in cols]
        table_set = set(merged.tolist())
        for k in counts:
            assert k in table_set, f"lookup value {k} not in table {tt.name()}"
        mult = np.zeros(np2, dtype=np.uint64)
        if np2 != n:
            vals, occ = np.unique(merged, return_counts=True)
            occ_map = dict(zip(vals.tolist(), occ.tolist()))
            for i, val in enumerate(merged.tolist()):
                c = counts.get(val)
                if c:
                    mult[i] = (c % host.P) * pow(occ_map[val], host.P - 2, host.P) % host.P
        else:
            for i, val in enumerate(merged.tolist()):
                mult[i] = counts.get(val, 0)
        device = ctx.device
        mult_gf = gf.from_u64(mult, device)
        table_witnesses.append(
            LogUpWitness(
                polys=[mult_gf],
                column_evals=[gf.from_u64(c, device) for c in cols],
                columns_per_instance=len(cols),
                table_type=tt,
                multiplicities=mult_gf,
            )
        )
    every = [w for ws in logup_witnesses.values() for w in ws] + table_witnesses
    comms = iter(ctx.commitment_ctx.commit_many([p for w in every for p in w.polys]))
    for w in every:
        w.commits = [(next(comms), p) for p in w.polys]
    storage = ChallengeStorage.initialise(list(element_count), transcript)
    return storage, logup_witnesses, table_witnesses
