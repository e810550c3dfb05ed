"""The fused sumcheck: every round on the device, the Fiat-Shamir sponge
included, with no host read, as the JAX package's `sumcheck/fused.py`.

`prove_device(vp, dt)` absorbs [n, max_degree] and proves `vp` against the
session `dt`. On a CUDA session the MLEs are laid end to end in one
extension array (two int64 planes), each row at its own length (a row
shorter than 2^n stands for its tiling over the high variables and is
read modulo its length), and `csrc/sumcheck.cu` runs the rounds:
while the rows are longer than 2^(TAIL_LOG + 1), each round is a
`round_kernel` over a grid the size of the card (`round_config`: fold the
previous challenge, form the message; its work laid out on the host once a
shape by `round_plan`, one unit a product and pair of the product's own
longest factor, so that a round costs the rows' own entries) and a
one-block `finish_kernel` (sum the blocks' partial messages, absorb the
message, squeeze the next challenge); then one `tail_kernel` runs every
remaining round as one cooperative launch over the whole card
(`tail_config`).
A sumcheck of n > TAIL_LOG variables is 2 (n - TAIL_LOG) + 1 launches,
one otherwise, besides the sponge launch of [n, max_degree]. On a CPU
session the plain version runs: the per-round path of `prover.py` over the
CPU state, whose messages, challenges and final evaluations the kernels
equal bit for bit (the split at the tail changes none of them).

Unlike the JAX package, nothing is padded to size buckets: padding bounded
XLA's compiles, and the messages are the same without it.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from .. import kernels
from ..fields import gf
from ..fields.gf import GF2
from . import prover
from .prover import ProverOutput, SumcheckProof, VirtualPolynomial

# Rounds run in the tail once a row is at most 2^TAIL_LOG long after the
# fold. Measured on an H100 (scripts/sweep_tail_log.py, PERF.md): of 8 to
# 14, 14 gives the batch opening its least device time (7.58 ms against
# 8.41 at 10), every other main-path shape within 1 % of its least (from 12
# on each runs wholly in the tail), and the fewest launches (the LeNet's
# sumchecks 173 against 291 at 10).
TAIL_LOG = 14
MAX_DEGREE = 5  # the main path's largest: the maxpool zerocheck

# Launches of each kernel since the last reset (plain ints; callers reset),
# and the shape of the CUDA sumcheck with the most stacked entries since
# then (num_vars, rows, each row's log-length, the products' factor lists,
# degree; callers reset).
LAUNCHES = {"sumcheck_round": 0, "sumcheck_finish": 0, "sumcheck_tail": 0}
LARGEST = {"num_vars": 0, "rows": 0, "row_vars": [], "entries": 0, "factors": [], "degree": 0}

_LIB = None
_CACHE: dict = {}


def _lib():
    global _LIB
    if _LIB is None:
        lib = kernels.library()
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.dp_sumcheck_round.argtypes = [i, p, p, p, p, i, p, i, ll, p, p, i, p, p, ll, p, p, p,
                                          ctypes.POINTER(i), p]
        lib.dp_sumcheck_round_config.argtypes = [i, i, i] + [ctypes.POINTER(i)] * 3
        lib.dp_sumcheck_finish.argtypes = [i, p, ll, i, i, p, p, p, p]
        lib.dp_sumcheck_tail.argtypes = [i, p, p, p, p, i, p, ll, i, i, p, i, p, p, p, p, p, p, p, p]
        lib.dp_sumcheck_tail_config.argtypes = [i] + [ctypes.POINTER(ctypes.c_int)] * 3
        for fn in (lib.dp_sumcheck_round, lib.dp_sumcheck_round_config, lib.dp_sumcheck_finish,
                   lib.dp_sumcheck_tail, lib.dp_sumcheck_tail_config):
            fn.restype = ctypes.c_int
        deg = ctypes.c_int()
        lib.dp_sumcheck_limits.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dp_sumcheck_limits(ctypes.byref(deg))
        if deg.value != MAX_DEGREE:
            raise RuntimeError(f"sumcheck.cu takes degree {deg.value}, the wrapper {MAX_DEGREE}")
        _LIB = lib
    return _LIB


def _cached(key, make):
    """A small constant tensor, built once per key (a copy from pageable host
    memory waits for the device, so it is not made anew on every call)."""
    if key not in _CACHE:
        _CACHE[key] = make()
    return _CACHE[key]


# ---------------------------------------------------------------------------
# the CUDA path
# ---------------------------------------------------------------------------


def factor_index(vp: VirtualPolynomial, degree: int, device) -> torch.Tensor:
    """(products, degree) int32 factor rows, -1 for the constant 1."""
    key = ("fidx", tuple(tuple(f) for _, f in vp.products), degree, str(device))
    return _cached(key, lambda: torch.tensor(
        [list(f) + [-1] * (degree - len(f)) for _, f in vp.products], dtype=torch.int32,
    ).to(device))


def coefficients(vp: VirtualPolynomial, device) -> GF2:
    """The products' coefficients as contiguous GF2 (products,) on `device`
    (host-pair coefficients made once per list)."""
    if vp.coeffs_dev is None and all(not isinstance(c, GF2) for c, _ in vp.products):
        key = ("coeffs", tuple((int(a), int(b)) for (a, b), _ in vp.products), str(device))
        return _cached(key, lambda: prover._coeffs(vp, device))
    c = prover._coeffs(vp, device)
    return GF2(c.a0.contiguous(), c.a1.contiguous())


@dataclasses.dataclass
class Stacked:
    """The rows of a sumcheck laid end to end for the kernels: the first
    buffer's planes (a0, a1), each row's word (offset << 6 | log-length,
    csrc/sumcheck.cu), the rows' log-lengths and offsets, and the longest
    row's length. `second()` makes the other buffer (room for every row
    folded once) when the rounds start."""

    first: tuple
    meta: torch.Tensor
    row_vars: list
    offsets: list
    length: int

    @property
    def rows(self) -> int:
        return len(self.row_vars)

    def row(self, i: int) -> GF2:
        """Row i's place in the first buffer, a GF2 view."""
        o, n = self.offsets[i], 1 << self.row_vars[i]
        return GF2(self.first[0][o : o + n], self.first[1][o : o + n])

    def second(self) -> tuple:
        half = torch.empty((2, self.first[0].numel() // 2), dtype=torch.int64, device=self.first[0].device)
        return half[0], half[1]


def _layout(row_vars: list, device, planes=None) -> Stacked:
    """Rows of 2^row_vars[i] entries end to end in `planes`, or in new empty
    ones. A row of one or two entries takes four places, so that every row
    starts at a multiple of 4 entries: at 16 bytes in the first buffer and,
    at offset / 2, in the second, for the round kernel's 16-byte words."""
    offsets, off = [], 0
    for lg in row_vars:
        offsets.append(off)
        off += max(4, 1 << lg)
    if planes is None:
        planes = torch.empty((2, off), dtype=torch.int64, device=device)
    words = tuple((o << 6) | lg for o, lg in zip(offsets, row_vars))
    meta = _cached(("meta", words, str(device)), lambda: torch.tensor(words, dtype=torch.int64).to(device))
    return Stacked(first=(planes[0], planes[1]), meta=meta, row_vars=list(row_vars), offsets=offsets,
                   length=1 << max(row_vars))


def empty_stack(row_vars: list, device) -> Stacked:
    """Empty planes for rows of 2^row_vars[i] entries, to be filled through
    `Stacked.row`: a caller that builds its rows in place keeps no second
    copy of them (`prove_device`'s `stacked`)."""
    return _layout(row_vars, device)


def stack_planes(vp: VirtualPolynomial) -> Stacked:
    """The MLEs' rows end to end, each at its own length, in fresh planes."""
    rows = [gf.to_ext(m) for m in vp.mles]
    row_vars = [r.shape[1].bit_length() - 1 for r in rows for _ in range(r.shape[0])]
    if min(row_vars) > 1:  # no row of one or two entries: the rows are the planes, one copy each
        planes = [torch.cat([getattr(r, a).reshape(-1) for r in rows]) for a in ("a0", "a1")]
        return _layout(row_vars, rows[0].device, planes)
    st = _layout(row_vars, rows[0].device)
    for i, (r, k) in enumerate((r, k) for r in rows for k in range(r.shape[0])):
        st.row(i).a0.copy_(r.a0[k])
        st.row(i).a1.copy_(r.a1[k])
    return st


def row_words(m: int, length: int, drop: int, device) -> tuple[torch.Tensor, int]:
    """The words of m rows of `length` that have had `drop` folds, end to end
    in the buffer that holds them, and the entries the other buffer needs:
    a caller that starts the kernels part way through a sumcheck (timing)."""
    scale = 2 if drop & 1 else 1
    lg = length.bit_length() - 1 + drop
    words = torch.tensor([((i * length * scale) << 6) | lg for i in range(m)], dtype=torch.int64).to(device)
    return words, m * length * scale * 2 if drop & 1 else m * length // 2


# ---------------------------------------------------------------------------
# the round kernel's schedule
# ---------------------------------------------------------------------------

WRITES = 1 << 30  # a factor word's flag: this slot writes the row's folded entries (csrc/sumcheck.cu)


def _pairs(lg: int) -> int:
    """The pairs a row of 2^lg entries gives a round (a row of one entry: its one, twice)."""
    return 1 << (lg - 1) if lg > 0 else 1


@dataclasses.dataclass
class RoundPlan:
    """The round kernel's work over the rows' own entries, built on the host
    from the rows' log-lengths and the products' factor lists. An item is a
    product, or a row that no product lists (`finals` returns it, so it is
    folded all the same). `words[i]` is item i's product (-1 for a row
    alone), then `degree` factor words: the row, with WRITES in the one slot
    that writes the row's folded entries (its first listing), or -1 for the
    constant 1. `tops[i]` is the log-length of the item's longest row."""

    words: list
    tops: list

    def spans(self, rnd: int) -> list:
        """Each item's units in round rnd: the pairs of its longest row after
        the round's fold (a row alone has none in round 0, which folds
        nothing)."""
        return [0 if w[0] < 0 and rnd == 0 else _pairs(max(top - rnd, 0)) for w, top in zip(self.words, self.tops)]

    def bases(self, rnd: int) -> list:
        """Item i's units in round rnd are bases[i] .. bases[i + 1] - 1."""
        out = [0]
        for s in self.spans(rnd):
            out.append(out[-1] + s)
        return out


def round_plan(row_vars, factors, degree: int) -> RoundPlan:
    """The round kernel's items for rows of 2^row_vars[i] entries and the
    products' factor lists: the products in their order, then the rows that
    no product lists."""
    seen, words, tops = set(), [], []
    for p, f in enumerate(factors):
        slots = []
        for r in f:
            slots.append(r if r in seen else r | WRITES)
            seen.add(r)
        words.append([p] + slots + [-1] * (degree - len(f)))
        tops.append(max((row_vars[r] for r in f), default=0))
    for r in range(len(row_vars)):
        if r not in seen:
            words.append([-1, r | WRITES] + [-1] * (degree - 1))
            tops.append(row_vars[r])
    return RoundPlan(words=words, tops=tops)


@dataclasses.dataclass
class Schedule:
    """A RoundPlan on the device: the item words (items, degree + 1) int32,
    every round's bases (n, items + 1) int64, and each round's units."""

    items: int
    words: torch.Tensor
    bases: torch.Tensor
    work: list


def schedule(row_vars, factors, degree: int, n: int, device) -> Schedule:
    """The Schedule of a sumcheck of n variables, built once per shape (as
    `meta`)."""
    key = ("schedule", tuple(row_vars), tuple(tuple(f) for f in factors), degree, n, str(device))

    def make():
        plan = round_plan(row_vars, factors, degree)
        bases = [plan.bases(rnd) for rnd in range(n)]
        return Schedule(items=len(plan.words), words=torch.tensor(plan.words, dtype=torch.int32).to(device),
                        bases=torch.tensor(bases, dtype=torch.int64).to(device), work=[b[-1] for b in bases])

    return _cached(key, make)


def _check(degree: int, device) -> None:
    if device.type != "cuda":
        raise ValueError(f"the sumcheck kernels take CUDA tensors, got {device}")
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"the sumcheck kernels take degree 1..{MAX_DEGREE}, got {degree}")


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def round_config(degree: int, items: int, m: int) -> dict:
    """The round kernel's grid at `degree` for `items` items over m rows on
    the current device: its most blocks (every SM, as many as the occupancy
    calculator lets it hold: the partial rows a launch writes at most),
    blocks an SM, and the bytes of shared memory its tables take (0: they
    stay in device memory). Raises if the card can hold none."""
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"the sumcheck kernels take degree 1..{MAX_DEGREE}, got {degree}")
    blocks, per_sm, stage = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().dp_sumcheck_round_config(degree, items, m, ctypes.byref(blocks), ctypes.byref(per_sm),
                                          ctypes.byref(stage))
    kernels.check(err, "sumcheck round grid query")
    return {"blocks": blocks.value, "blocks_per_sm": per_sm.value, "stage_bytes": stage.value}


def round_cuda(src, dst, meta, m: int, drop: int, length: int, chals, rnd: int, n: int, sched: Schedule,
               coeffs: GF2, partials, degree: int) -> int:
    """round_kernel on the m rows in src (a0, a1) after `drop` folds (placed
    by `meta`, the longest `length` long): fold by challenge rnd - 1 of
    chals (2, n) into dst (skipped when rnd == 0; dst None) over the units
    of round rnd of `sched`; partial messages into `partials`, a row a
    block. Returns the number of blocks."""
    _check(degree, src[0].device)
    lib = _lib()
    fold = rnd > 0
    count = length // 4 if fold else length // 2  # the round's pairs
    if count < 1:
        raise ValueError(f"a round needs rows of at least {4 if fold else 2}, got {length}")
    if count != 1 << (n - rnd - 1):
        raise ValueError(f"round {rnd} of {n} on rows of {length}")
    if any(t.data_ptr() % 16 for t in tuple(src) + (tuple(dst) if fold else ())):
        raise ValueError("the round kernel moves rows in 16-byte words: align the planes to 16 bytes")
    r0 = chals[0, rnd - 1] if fold else None
    r1 = chals[1, rnd - 1] if fold else None
    blocks = ctypes.c_int()
    with torch.cuda.device(src[0].device):
        if partials.numel() < round_config(degree, sched.items, m)["blocks"] * 2 * (degree + 1):
            raise ValueError("partials scratch too small")
        err = lib.dp_sumcheck_round(
            degree, src[0].data_ptr(), src[1].data_ptr(),
            _ptr(dst[0]) if fold else None, _ptr(dst[1]) if fold else None, m, meta.data_ptr(), drop, count,
            _ptr(r0), _ptr(r1), sched.items, sched.words.data_ptr(), sched.bases[rnd].data_ptr(),
            sched.work[rnd], coeffs.a0.data_ptr(), coeffs.a1.data_ptr(), partials.data_ptr(),
            ctypes.byref(blocks), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "sumcheck round kernel launch")
    LAUNCHES["sumcheck_round"] += 1
    return blocks.value


def finish_cuda(partials, blocks: int, rnd: int, n: int, msgs, chals, state, degree: int) -> None:
    """finish_kernel: message `rnd` from the partials into msgs (2, n,
    degree + 1), absorbed; its challenge into chals (2, n)."""
    _check(degree, state.device)
    if partials.data_ptr() % 16:
        raise ValueError("the finish kernel reads the partials in 16-byte words: align them to 16 bytes")
    lib = _lib()
    with torch.cuda.device(state.device):
        err = lib.dp_sumcheck_finish(
            degree, partials.data_ptr(), blocks, rnd, n, msgs.data_ptr(), chals.data_ptr(),
            state.data_ptr(), torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "sumcheck finish kernel launch")
    LAUNCHES["sumcheck_finish"] += 1


def tail_config(degree: int) -> dict:
    """The tail kernel's launch at `degree`: the blocks of its cooperative
    grid (every SM, as many as the occupancy calculator lets it hold),
    threads a block, and blocks an SM. Raises if the card can hold none."""
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"the sumcheck kernels take degree 1..{MAX_DEGREE}, got {degree}")
    blocks, threads, per_sm = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    err = _lib().dp_sumcheck_tail_config(degree, ctypes.byref(blocks), ctypes.byref(threads),
                                         ctypes.byref(per_sm))
    kernels.check(err, "sumcheck tail grid query")
    return {"blocks": blocks.value, "threads": threads.value, "blocks_per_sm": per_sm.value}


def tail_cuda(cur, other, meta, m: int, length: int, rnd0: int, n: int, fidx, coeffs: GF2, msgs,
              chals, state, finals, degree: int) -> None:
    """tail_kernel, one cooperative launch over the card: rounds rnd0..n-1
    on the m rows in cur (rounds before rnd0 - 1 folded in, placed by
    `meta`, the longest `length` long; folding first by challenge rnd0 - 1
    when rnd0 > 0), ping-ponging with `other`; both are overwritten. The
    last fold goes into finals (2, m). Raises if the card refuses the grid."""
    _check(degree, state.device)
    lib = _lib()
    if n - rnd0 < 1 or length != 1 << (n - rnd0 + (1 if rnd0 else 0)):
        raise ValueError(f"tail of rounds {rnd0}..{n - 1} on rows of {length}")
    with torch.cuda.device(state.device):
        blocks = tail_config(degree)["blocks"]
        # a row of partial message a block, then the round's challenge
        scratch = torch.empty(blocks * 2 * (degree + 1) + 2, dtype=torch.int64, device=state.device)
        err = lib.dp_sumcheck_tail(
            degree, cur[0].data_ptr(), cur[1].data_ptr(), other[0].data_ptr(),
            other[1].data_ptr(), m, meta.data_ptr(), length, rnd0, n, fidx.data_ptr(), fidx.shape[0],
            coeffs.a0.data_ptr(), coeffs.a1.data_ptr(), msgs.data_ptr(), chals.data_ptr(),
            state.data_ptr(), finals.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "sumcheck tail kernel launch")
    LAUNCHES["sumcheck_tail"] += 1


def prove_rounds_cuda(vp: VirtualPolynomial, dt, n: int, degree: int, st: Stacked | None = None):
    """The n >= 1 rounds by the kernels on a CUDA session (after [n, degree]
    is absorbed), on `st` (the MLEs' rows laid out already; overwritten) or
    on a fresh copy of the rows: (msgs GF2 (n, degree + 1), chals GF2 (n,),
    finals GF2 (m,))."""
    dev = dt.device
    st = stack_planes(vp) if st is None else st
    m, length = st.rows, st.length
    fidx = factor_index(vp, degree, dev)
    coeffs = coefficients(vp, dev)
    entries = st.first[0].numel()
    if entries > LARGEST["entries"]:
        LARGEST.update(num_vars=n, rows=m, row_vars=list(st.row_vars), entries=entries,
                       factors=[list(f) for _, f in vp.products], degree=degree)
    msgs = torch.empty((2, n, degree + 1), dtype=torch.int64, device=dev)
    chals = torch.empty((2, n), dtype=torch.int64, device=dev)
    finals = torch.empty((2, m), dtype=torch.int64, device=dev)
    cur, other = st.first, st.second()
    above = max(0, n - TAIL_LOG)
    if above:
        sched = schedule(st.row_vars, [f for _, f in vp.products], degree, n, dev)
        grid = round_config(degree, sched.items, m)["blocks"]
        partials = torch.empty(grid * 2 * (degree + 1), dtype=torch.int64, device=dev)
    for rnd in range(above):
        drop = max(rnd - 1, 0)
        blocks = round_cuda(cur, other, st.meta, m, drop, length, chals, rnd, n, sched, coeffs, partials, degree)
        finish_cuda(partials, blocks, rnd, n, msgs, chals, dt.state, degree)
        if rnd:
            cur, other, length = other, cur, length // 2
    tail_cuda(cur, other, st.meta, m, length, above, n, fidx, coeffs, msgs, chals, dt.state, finals, degree)
    return GF2(msgs[0], msgs[1]), GF2(chals[0], chals[1]), GF2(finals[0], finals[1])


def prove_device(vp: VirtualPolynomial, dt, stacked: Stacked | None = None) -> ProverOutput:
    """Sumcheck against a session transcript; the output holds device values
    (lower with glue.materialize). `stacked`: the MLEs' rows already laid
    out by `empty_stack`, in order (the MLEs views of its rows); the CUDA
    rounds overwrite it."""
    if dt.device.type == "cpu":
        return prover.prove_device(vp, dt)
    n, degree = vp.num_vars, vp.max_degree
    dt.append_constants([n, degree])
    if n == 0:
        proof = SumcheckProof(point=gf.ext_zeros((0,), dt.device),
                              round_messages=gf.ext_zeros((0, degree + 1), dt.device))
        stacked = prover._stacked(vp, degree)
        return ProverOutput(proof=proof, final_evals=stacked[: vp.num_mles].reshape(-1))
    msgs, chals, finals = prove_rounds_cuda(vp, dt, n, degree, stacked)
    return ProverOutput(proof=SumcheckProof(point=chals, round_messages=msgs), final_evals=finals)


def prove_fused(vp: VirtualPolynomial, transcript) -> ProverOutput:
    """Host-transcript API: proves on the device of the MLEs; returns host
    values and advances `transcript`, in one read."""
    from ..transcript.session import DeviceTranscript

    dt = DeviceTranscript.from_host(transcript, vp.mles[0].device)
    return dt.materialize(prove_device(vp, dt), transcript)
