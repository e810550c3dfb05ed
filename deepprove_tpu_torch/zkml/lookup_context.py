"""Lookup tables and witness generation, as in the JAX package's
`zkml/lookup_context.py`.

Each table has (a) a merged Element column `in + 2^32 out` against which
the looked-up values are counted and (b) its base-field columns, which the
table proof proves and the verifier evaluates in closed form. Tables sort
by kind, then parameters. The port has relu, range, clamping, gelu and
inv_sqrt; softmax, error and zero arrive with attention. The gelu and
inv_sqrt rows are built in float64 numpy on the host, as the JAX package
builds them (a rounding difference would change the table), and their
output columns are committed at setup: their claims go to the batched
opening (`table_claims`).
"""

from __future__ import annotations

import dataclasses
import struct
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
_LATER = ("softmax", "error", "zero")

LAYERNORM_SCALE_FACTOR = 1 << 24
LAYERNORM_OUTPUT_SCALE_FACTOR = 1 << 10


def _f32_bits(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", v))[0]


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _host_field(x: np.ndarray) -> np.ndarray:
    """int64 Elements -> canonical Goldilocks u64 (negatives wrap mod p)."""
    a = np.asarray(x, dtype=np.int64)
    return np.where(a < 0, np.uint64(host.P) - (-a).astype(np.uint64), a.astype(np.uint64))


@total_ordering
@dataclasses.dataclass(frozen=True)
class TableType:
    """kind in {relu, gelu, range, clamping, inv_sqrt} (the JAX package's
    softmax, error and zero sort here but raise); params is a kind-specific
    tuple: the clamping bit size; gelu's input and output scales and
    inv_sqrt's epsilon as float32 bit patterns, inv_sqrt's shift."""

    kind: str
    params: tuple = ()

    def __lt__(self, other):
        return (_ORDER[self.kind], self.params) < (_ORDER[other.kind], other.params)

    def _check(self):
        if self.kind in _LATER:
            raise NotImplementedError(
                f"lookup table {self.kind!r} arrives with the port's attention slice (ROADMAP queue 1 item 4)"
            )

    def name(self) -> str:
        self._check()
        if self.kind == "clamping":
            return f"Clamping: {self.params[0]}"
        if self.kind == "gelu":
            return "gelu"
        if self.kind == "inv_sqrt":
            return f"InverseSQRT - normalisation: {_f32(self.params[0])}, shift: {self.params[1]}"
        return {"relu": "Relu", "range": "Range"}[self.kind]

    def table_columns(self) -> tuple[np.ndarray, list[np.ndarray]]:
        """(merged Element column, [base-field u64 columns])."""
        self._check()
        if self.kind == "range":
            i = np.arange(0, 1 << Q.BIT_LEN, dtype=np.int64)
            return i.copy(), [_host_field(i)]
        if self.kind == "relu":
            i = np.arange(Q.MIN - 1, Q.MAX + 1, dtype=np.int64)
            out = np.maximum(i, 0)
        elif self.kind == "clamping":
            mx = 1 << (self.params[0] - 1)
            i = np.arange(-mx, mx, dtype=np.int64)
            out = np.clip(i, Q.MIN, Q.MAX)
        else:
            i, out = (gelu_rows if self.kind == "gelu" else inv_sqrt_rows)(self.params)
        return i + out * COLUMN_SEPARATOR, [_host_field(i), _host_field(out)]

    def num_columns(self) -> int:
        self._check()
        return 1 if self.kind == "range" else 2

    def multiplicity_poly_vars(self) -> int:
        self._check()
        if self.kind == "clamping":
            return self.params[0]
        if self.kind == "inv_sqrt":
            return 2 * (Q.BIT_LEN - 1) + 1
        return Q.BIT_LEN

    def committed_columns(self, device):
        """The columns the PCS commits at setup, as a field tensor on
        `device`: the output column of gelu and inv_sqrt; None otherwise."""
        self._check()
        if self.kind not in ("gelu", "inv_sqrt"):
            return None
        return gf.from_u64(self.table_columns()[1][1], device)

    def generate_challenge(self, transcript):
        """The table's column-separation challenge: a host pair from a host
        transcript, a device GF2 () from a session."""
        self._check()
        if self.kind == "range":
            dev = getattr(transcript, "device", None)
            return (1, 0) if dev is None else gf.ext_ones((), dev)
        label = {"relu": b"Relu", "clamping": b"Clamping", "gelu": b"GELU", "inv_sqrt": b"InverseSQRT"}
        return transcript.get_and_append_challenge(label[self.kind])

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
        if self.kind in ("gelu", "inv_sqrt"):
            # rows run from the table's least input; the output is committed
            assert len(point) == self.multiplicity_poly_vars()
            return [host.ext_sub(ident(point), ((1 << (len(point) - 1)) % host.P, 0))]
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
        """Claims that go to the commitment accumulator: the committed output
        column's (the last claim) of gelu and inv_sqrt."""
        self._check()
        return [claims[-1]] if self.kind in ("gelu", "inv_sqrt") else []

    @staticmethod
    def inv_sqrt(eps: float, range_check_bits: int) -> "TableType":
        return TableType("inv_sqrt", (_f32_bits(eps), range_check_bits))


def gelu_table_type(s_in: float, s_out: float) -> TableType:
    return TableType("gelu", (_f32_bits(s_in), _f32_bits(s_out)))


def gelu_rows(params) -> tuple[np.ndarray, np.ndarray]:
    """GELU rows: inputs MIN - 1 ..= MAX, out = quant(gelu(dequant(i))) at
    the float32 scales of `params`, in float64 numpy."""
    s_in, s_out = _f32(params[0]), _f32(params[1])
    i = np.arange(Q.MIN - 1, Q.MAX + 1, dtype=np.int64)
    x = i.astype(np.float64) * s_in
    g = 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))
    return i, np.clip(np.round(g / s_out), Q.MIN, Q.MAX).astype(np.int64)


def inv_sqrt_rows(params) -> tuple[np.ndarray, np.ndarray]:
    """InverseSQRT rows -2^(2(B-1)) .. 2^(2(B-1)) - 1, out =
    round(2^10 / sqrt(v 2^rc / 2^24 + eps)) (0 where not finite), in float64
    numpy."""
    eps, rc_bits = _f32(params[0]), params[1]
    mx = 1 << (2 * (Q.BIT_LEN - 1))
    i = np.arange(-mx, mx, dtype=np.int64)
    shifted = (i.astype(np.float64) * float(1 << rc_bits)) / float(LAYERNORM_SCALE_FACTOR)
    with np.errstate(invalid="ignore", divide="ignore"):
        f = 1.0 / np.sqrt(shifted + eps)
    out = np.where(np.isfinite(f), np.round(f * LAYERNORM_OUTPUT_SCALE_FACTOR), 0.0).astype(np.int64)
    return i, out


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
