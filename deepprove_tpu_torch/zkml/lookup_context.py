"""Lookup tables and witness generation, as in the JAX package's
`zkml/lookup_context.py`.

Each table has (a) a merged Element column `in + 2^32 out` against which
the looked-up values are counted and (b) its base-field columns, which the
table proof proves and the verifier evaluates in closed form. Tables sort
by kind, then parameters. The columns are made on the device: arange,
clamp and the table's rule for relu, range, clamping and zero; the gelu,
inv_sqrt and softmax rows and the error column are built in float64 numpy
on the host, as the JAX package builds them (a rounding difference would
change the table), and copied once. Their committed columns (the output of
gelu, inv_sqrt and softmax, error's only column) are committed at setup:
their claims go to the batched opening (`table_claims`).

The lookups are counted on the device too: each node hands over its
looked-up merged values, a value maps to its row by an offset where the
table's input column is an arange, else by a search in the sorted merged
column, and one scatter-add a table counts them. A value that is not in
its table fails one check a table (the table's one read of the device).
"""

from __future__ import annotations

import dataclasses
import struct
from functools import total_ordering

import numpy as np
import torch

from ..fields import gf, host
from . import quantization as Q
from .tensor import ceil_log2

COLUMN_SEPARATOR = 1 << 32
ExtPair = tuple[int, int]

_ORDER = {
    "relu": 0, "gelu": 1, "range": 2, "clamping": 3,
    "softmax": 4, "error": 5, "zero": 6, "inv_sqrt": 7,
}

LOG_SCALE_FACTOR = 24
SCALE_FACTOR = 1 << LOG_SCALE_FACTOR
OUTPUT_SCALE_FACTOR = 1 << 12
LAYERNORM_SCALE_FACTOR = 1 << 24
LAYERNORM_OUTPUT_SCALE_FACTOR = 1 << 10


def _f32_bits(v: float) -> int:
    return struct.unpack("<I", struct.pack("<f", v))[0]


def _f32(bits: int) -> float:
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def _ident(pt) -> ExtPair:
    """The MLE of the row index at `pt`: sum_i 2^i pt_i."""
    acc = (0, 0)
    for i, p in enumerate(pt):
        acc = host.ext_add(acc, host.ext_mul(p, ((1 << i) % host.P, 0)))
    return acc


def _prefix_eq(point, bound: int) -> ExtPair:
    """sum_{x < bound} eq(point, x) over x in [0, 2^len(point)), little-endian:
    for every set bit k of the bound, the rows that agree with it above k
    and have a 0 at k, whose lower bits sum eq to 1."""
    if bound >= 1 << len(point):
        return (1, 0)
    one = (1, 0)
    acc, above = (0, 0), one
    for k in range(len(point) - 1, -1, -1):
        r = point[k]
        if (bound >> k) & 1:
            acc = host.ext_add(acc, host.ext_mul(above, host.ext_sub(one, r)))
            above = host.ext_mul(above, r)
        else:
            above = host.ext_mul(above, host.ext_sub(one, r))
    return acc


def _eq_at(point, x: int) -> ExtPair:
    """eq(point, bits of x)."""
    acc = (1, 0)
    for k, r in enumerate(point):
        acc = host.ext_mul(acc, r if (x >> k) & 1 else host.ext_sub((1, 0), r))
    return acc


def clamping_out_eval(size: int, point) -> ExtPair:
    """The MLE at `point` of the clamping table's output column
    clip(x, MIN, MAX), x in [-2^(size-1), 2^(size-1)), without its rows: MIN
    times the eq mass of the rows below MIN, the rows in range one by one,
    MAX times the eq mass of the rows above MAX (O(size) each bound)."""
    n, mx, p = 1 << size, 1 << (size - 1), host.P
    lo = min(max(mx + Q.MIN, 0), n)  # the first row whose value is >= MIN
    hi = min(max(mx + Q.MAX + 1, 0), n)  # the first row whose value is > MAX
    below = _prefix_eq(point, lo)
    above = host.ext_sub((1, 0), _prefix_eq(point, hi))
    acc = host.ext_add(host.ext_mul((Q.MIN % p, 0), below), host.ext_mul((Q.MAX % p, 0), above))
    for x in range(lo, hi):
        acc = host.ext_add(acc, host.ext_mul(((x - mx) % p, 0), _eq_at(point, x)))
    return acc


@total_ordering
@dataclasses.dataclass(frozen=True)
class TableType:
    """kind in {relu, gelu, range, clamping, softmax, error, zero, inv_sqrt};
    params is a kind-specific tuple: the clamping and zero bit sizes;
    gelu's input and output scales, softmax's inverse temperature and
    inv_sqrt's epsilon as float32 bit patterns; softmax's table bits and
    cutoff; error's quantised one and allowable error; inv_sqrt's shift."""

    kind: str
    params: tuple = ()

    def __lt__(self, other):
        return (_ORDER[self.kind], self.params) < (_ORDER[other.kind], other.params)

    def name(self) -> str:
        if self.kind == "clamping":
            return f"Clamping: {self.params[0]}"
        if self.kind == "zero":
            return f"Zero: {self.params[0]}"
        if self.kind == "error":
            return f"Error Table - quantised one: {self.params[0]}, allowable error: {self.params[1]}"
        if self.kind == "softmax":
            return f"Softmax - temperature: {_f32(self.params[0])}"
        if self.kind == "inv_sqrt":
            return f"InverseSQRT - normalisation: {_f32(self.params[0])}, shift: {self.params[1]}"
        return {"relu": "Relu", "range": "Range", "gelu": "gelu"}[self.kind]

    def row_offset(self) -> int | None:
        """The input of the first row where the input column is an arange
        (a value's row is its input minus this), None for the error table."""
        if self.kind in ("range", "zero", "softmax"):
            return 0
        if self.kind in ("relu", "gelu"):
            return Q.MIN - 1
        if self.kind == "clamping":
            return -(1 << (self.params[0] - 1))
        if self.kind == "inv_sqrt":
            return -(1 << (2 * (Q.BIT_LEN - 1)))
        return None

    def _rows(self, device):
        """The input column and the output column (None for the one-column
        range and error tables) as int64 Elements on `device`."""
        if self.kind == "error":
            return torch.from_numpy(error_rows(self.params)).to(device), None
        if self.kind in ("gelu", "inv_sqrt", "softmax"):
            rows = {"gelu": gelu_rows, "inv_sqrt": inv_sqrt_rows, "softmax": softmax_rows}[self.kind]
            i, out = (torch.from_numpy(a).to(device) for a in rows(self.params))
            return i, out
        n = 1 << self.multiplicity_poly_vars()
        i = torch.arange(self.row_offset(), self.row_offset() + n, dtype=torch.int64, device=device)
        if self.kind == "range":
            return i, None
        if self.kind == "relu":
            return i, i.clamp(min=0)
        if self.kind == "clamping":
            return i, i.clamp(Q.MIN, Q.MAX)
        return i, (i == 0).to(torch.int64)

    def merged_column(self, device="cpu") -> torch.Tensor:
        """The merged Element column `in + 2^32 out` on `device`."""
        i, out = self._rows(device)
        return i if out is None else i + out * COLUMN_SEPARATOR

    def table_columns(self, device="cpu") -> tuple[torch.Tensor, list[torch.Tensor]]:
        """(merged int64 Element column, [base-field columns]) on `device`."""
        i, out = self._rows(device)
        if out is None:
            return i, [Q.to_field(i)]
        return i + out * COLUMN_SEPARATOR, [Q.to_field(i), Q.to_field(out)]

    def num_columns(self) -> int:
        return 1 if self.kind in ("range", "error") else 2

    def multiplicity_poly_vars(self) -> int:
        if self.kind in ("clamping", "zero"):
            return self.params[0]
        if self.kind == "softmax":
            return self.params[1]
        if self.kind == "error":
            return ceil_log2(2 * self.params[1])
        if self.kind == "inv_sqrt":
            return 2 * (Q.BIT_LEN - 1) + 1
        return Q.BIT_LEN

    def committed_columns(self, device):
        """The column the PCS commits at setup, as a field tensor on
        `device`: the output column of gelu, softmax and inv_sqrt, the error
        table's only column; None otherwise."""
        if self.kind not in ("gelu", "softmax", "inv_sqrt", "error"):
            return None
        return self.table_columns(device)[1][-1]

    def generate_challenge(self, transcript):
        """The table's column-separation challenge: a host pair from a host
        transcript, a device GF2 () from a session."""
        if self.kind in ("range", "error"):
            dev = getattr(transcript, "device", None)
            return (1, 0) if dev is None else gf.ext_ones((), dev)
        label = {"relu": b"Relu", "clamping": b"Clamping", "gelu": b"GELU", "inv_sqrt": b"InverseSQRT",
                 "zero": b"Zero", "softmax": b"Softmax"}
        return transcript.get_and_append_challenge(label[self.kind])

    def evaluate_table_columns(self, point: list[ExtPair]) -> list[ExtPair]:
        """The verifier's evaluations of the table columns at `point`, in
        closed form; a committed column has none (its claim is opened)."""
        assert len(point) == self.multiplicity_poly_vars()
        if self.kind == "error":
            return []
        if self.kind == "range":
            return [_ident(point)]
        if self.kind == "softmax":
            return [_ident(point)]
        first = host.ext_sub(_ident(point), ((-self.row_offset()) % host.P, 0))
        if self.kind in ("gelu", "inv_sqrt"):
            return [first]
        if self.kind == "zero":
            prod = (1, 0)
            for p in point:
                prod = host.ext_mul(prod, host.ext_sub((1, 0), p))
            return [_ident(point), prod]
        if self.kind == "relu":
            top = point[-1]
            second = (0, 0)
            for i, p in enumerate(point[:-1]):
                second = host.ext_add(second, host.ext_mul(host.ext_mul(p, ((1 << i) % host.P, 0)), top))
            return [first, second]
        return [first, clamping_out_eval(self.params[0], point)]

    def table_claims(self, claims: list) -> list:
        """Claims that go to the commitment accumulator: the committed
        column's (the last claim)."""
        return [claims[-1]] if self.kind in ("gelu", "softmax", "inv_sqrt", "error") else []

    @staticmethod
    def inv_sqrt(eps: float, range_check_bits: int) -> "TableType":
        return TableType("inv_sqrt", (_f32_bits(eps), range_check_bits))

    @staticmethod
    def softmax(inv_temperature: float, table_size: int, bkm: int) -> "TableType":
        return TableType("softmax", (_f32_bits(inv_temperature), table_size, bkm))

    @staticmethod
    def error(quant_one: int, allowable_error: int) -> "TableType":
        return TableType("error", (quant_one, allowable_error))


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


def softmax_rows(params) -> tuple[np.ndarray, np.ndarray]:
    """The softmax exp rows j in [0, 2^size): out = round(2^12 exp(-j 2^16 /
    (2^24 T))) in float32, 0 from the cutoff bkm on."""
    inv_temp, table_size, bkm = _f32(params[0]), params[1], params[2]
    j = np.arange(0, 1 << table_size, dtype=np.int64)
    prod = np.int64(1 << (LOG_SCALE_FACTOR - 8)) * j
    f = np.exp(-(prod.astype(np.float32)) / (np.float32(SCALE_FACTOR) * np.float32(inv_temp)))
    out = np.round(f * np.float32(OUTPUT_SCALE_FACTOR)).astype(np.int64)
    return j, np.where(prod >= bkm, 0, out)


def error_rows(params) -> np.ndarray:
    """The error table's one column: quant_one - err ..= quant_one + err,
    cut or zero-padded to 2^ceil_log2(2 err) rows."""
    quant_one, err = params
    vals = np.arange(quant_one - err, quant_one + err + 1, dtype=np.int64)
    size = 1 << ceil_log2(2 * err)
    out = np.zeros(size, dtype=np.int64)
    out[: min(size, vals.size)] = vals[:size]
    return out


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
    at once and fills in `commits`. A table's witness holds its
    multiplicities and no columns: `table_columns_padded` makes them when
    its proof runs."""

    polys: list
    column_evals: list | None
    columns_per_instance: int
    table_type: object
    multiplicities: torch.Tensor | None = None  # table witnesses only
    commits: list | None = None  # [(CommitmentWithWitness, poly)], in `polys` order

    def get_logup_input(self, storage: ChallengeStorage):
        from ..lookup import logup

        const_c, sep_c = storage.get(self.table_type.name())
        if self.multiplicities is not None:
            cols = table_columns_padded(self.table_type, self.multiplicities.device)
            return logup.LogUpInput.new_table(cols, self.multiplicities, const_c, sep_c)
        return logup.LogUpInput.new_lookup(self.column_evals, const_c, sep_c, self.columns_per_instance)


def _pad_rows(col: torch.Tensor) -> torch.Tensor:
    """A column that is not a power of two padded by repeating its rows."""
    n = col.shape[0]
    np2 = 1 << ceil_log2(n)
    return col if np2 == n else col[torch.arange(np2, device=col.device) % n]


def table_columns_padded(tt, device) -> list:
    """A table's field columns, padded to a power of two (`_pad_rows`)."""
    return [_pad_rows(c) for c in tt.table_columns(device)[1]]


def _bincount(rows: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of each row in [0, n): an integer scatter-add (torch's
    bincount reads the device for the largest row)."""
    return torch.zeros(n, dtype=torch.int64, device=rows.device).index_add_(0, rows, torch.ones_like(rows))


def count_lookups(tt, values: torch.Tensor, device) -> torch.Tensor:
    """The multiplicity column of table `tt` (a field tensor on `device`)
    for the looked-up merged values `values`. Every row holding a value
    gets its count, divided in the field by the value's repetitions where
    the table was padded to a power of two by repeating rows."""
    merged = tt.merged_column(device)
    n = merged.shape[0]
    merged = _pad_rows(merged)
    np2 = merged.shape[0]
    values = values.reshape(-1).to(device)
    offset = tt.row_offset()
    if offset is not None:
        assert np2 == n, "an arange-shaped table is a power of two"
        # the row's input is the value's low 32 bits, sign extended
        low = ((values + (1 << 31)) & ((1 << 32) - 1)) - (1 << 31)
        rows = low - offset
        inside = (rows >= 0) & (rows < np2)
        rows = rows.clamp(0, np2 - 1)
        bad = ~inside | (merged[rows] != values)
        counts = _bincount(rows, np2)
    else:
        ordered, _ = torch.sort(merged)
        pos = torch.searchsorted(ordered, values).clamp(max=np2 - 1)
        bad = ordered[pos] != values
        first = torch.searchsorted(ordered, merged)
        counts = _bincount(pos, np2)[first]
        if np2 != n:
            reps = torch.searchsorted(ordered, merged, right=True) - first
            counts = gf.mul(counts, gf.inv(reps))
    if bool(bad.any()):
        raise AssertionError(f"lookup value {int(values[bad][0])} not in table {tt.name()}")
    return counts


def generate_lookup_witnesses(trace, ctx, transcript):
    """Walk the trace forward collecting each node's lookup witnesses and
    looked-up values, count every table's multiplicities on the device,
    commit the polys of all the witnesses together (`commit_many`), then
    derive the challenge storage from `transcript` (a session, on the
    prover's side). Returns (storage, {node id: [LogUpWitness]}, [table
    LogUpWitness])."""
    looked_up: dict = {}
    logup_witnesses: dict = {}
    for node_id in ctx.forward_order():
        op = ctx.steps_info[node_id].op
        if not hasattr(op, "gen_lookup_witness"):
            continue
        witnesses, values = op.gen_lookup_witness(node_id, ctx, trace.steps[node_id])
        logup_witnesses[node_id] = witnesses
        for tt, v in values.items():
            looked_up.setdefault(tt, []).append(v.reshape(-1))

    table_witnesses = []
    for tt in sorted(looked_up):
        mult = count_lookups(tt, torch.cat(looked_up[tt]), ctx.device)
        table_witnesses.append(
            LogUpWitness(polys=[mult], column_evals=None, columns_per_instance=tt.num_columns(),
                         table_type=tt, multiplicities=mult)
        )
    every = [w for ws in logup_witnesses.values() for w in ws] + table_witnesses
    comms = iter(ctx.commitment_ctx.commit_many([p for w in every for p in w.polys]))
    for w in every:
        w.commits = [(next(comms), p) for p in w.polys]
    storage = ChallengeStorage.initialise(list(looked_up), transcript)
    return storage, logup_witnesses, table_witnesses
