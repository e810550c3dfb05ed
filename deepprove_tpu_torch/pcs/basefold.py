"""Basefold multilinear PCS (RS encoding + Poseidon2 Merkle + FRI-style fold).

The protocol of the JAX package's `pcs/basefold.py` on its Poseidon2 / RS
path, which is the one the zkml pipeline runs:

  * commit: evals -> multilinear coeffs -> bit-reverse -> RS encode at rate
    1/2 on the coset gamma*H -> bit-reverse codeword -> Merkle over
    adjacent leaf pairs. Polys <= the basecode size are committed
    trivially (Merkle over the raw evals).
  * open (commit phase): interleaved sumcheck of sum_b eq(b, point) f(b)
    with codeword folding; per round a 3-coefficient message, a
    b"commit round" challenge, a FRI fold and a Merkle commit of the
    folded oracle.
  * query phase: b"query indices" challenges; sibling pairs + Merkle paths
    through the committed codewords and every folded oracle; the verifier
    refolds down to encode(final_message).
  * batch_open: RLC of many (poly, point, eval) triples through a
    point-merging sumcheck, then one batched commit/query phase.

The prover runs on tensors of one device; the verifier is host code
(numpy + python ints), with the Merkle path walk (`PathJobs`) on the
caller's device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from .. import glue
from ..fields import gf, host
from ..fields.gf import GF2
from ..hashing import poseidon2
from ..hashing.poseidon2_cuda import compress_level
from ..poly import mle as mle_mod
from ..transcript.session import label_chunks
from . import ntt
from .merkle import MerkleTree
from .ntt import bit_reverse_perm

ExtPair = tuple[int, int]
Digest = tuple[int, int, int, int]

COMMIT_ROUND_LABEL = b"commit round"
QUERY_LABEL = b"query indices"


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BasefoldParams:
    """The reference's soundness parameters: rate 1/2, 200 queries,
    basecode message 2^7; other values are for tests."""

    max_message_size_log: int
    rate_log: int = 1
    num_queries: int = 200
    basecode_msg_size_log: int = 7

    @property
    def full_codeword_log(self) -> int:
        return self.max_message_size_log + self.rate_log

    def fold_coeffs_at(self, level: int, idxs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """`fold_coeffs_device(level)` at the positions `idxs` alone (the
        verifier's queries): x0 = w_{2^(level+1)}^rev(j) gamma^2^(full-level-1),
        w = -1/(2 x0), a power each."""
        p = host.P
        g = int(host.pow_const(np.uint64(host.TWO_ADIC_GENERATOR), 1 << (host.TWO_ADICITY - level - 1)))
        gamma_pow = int(host.pow_const(np.uint64(host.MULTIPLICATIVE_GENERATOR),
                                       1 << (self.full_codeword_log - level - 1)))
        half_gamma_inv = pow(gamma_pow, p - 2, p) * ((p + 1) >> 1) % p
        g_inv = pow(g, p - 2, p)
        x0, w = [], []
        for j in np.asarray(idxs, dtype=np.int64).tolist():
            rev = int(f"{j:0{level}b}"[::-1], 2) if level else 0
            x0.append(pow(g, rev, p) * gamma_pow % p)
            w.append(-pow(g_inv, rev, p) * half_gamma_inv % p)
        return np.asarray(x0, dtype=np.uint64), np.asarray(w, dtype=np.uint64)

    def fold_coeffs_device(self, level: int, device):
        """x0, w for folding a 2^(level+1) codeword to 2^level, on `device`:
        x0[j] = w_{2^(level+1)}^rev(j) * gamma^2^(full-level-1), w = -1/(2 x0)
        (`ntt.device_constant`: cached up to 2^CACHED_CONSTANTS_LOG entries)."""

        def make():
            g = host.pow_const(np.uint64(host.TWO_ADIC_GENERATOR), 1 << (host.TWO_ADICITY - level - 1))
            gamma_pow = host.pow_const(np.uint64(host.MULTIPLICATIVE_GENERATOR),
                                       1 << (self.full_codeword_log - level - 1))
            pows = ntt.bit_reverse(ntt.powers_device(int(g), 1 << level, device), level)
            x0 = gf.mul(pows, int(gamma_pow))
            del pows
            pows_inv = ntt.bit_reverse(ntt.powers_device(int(host.pow_const(g, host.P - 2)), 1 << level, device),
                                       level)
            half_gamma_inv = host.mul(host.pow_const(gamma_pow, host.P - 2), np.uint64((host.P + 1) >> 1))
            return x0, gf.neg(gf.mul(pows_inv, int(half_gamma_inv)))

        return ntt.device_constant(("fold", level, self.full_codeword_log), level, device, make)


def setup(max_message_size_log: int, **kw) -> BasefoldParams:
    return BasefoldParams(max_message_size_log=max_message_size_log, **kw)


# ---------------------------------------------------------------------------
# commitment
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BasefoldCommitment:
    """Verifier-side commitment: root + shape."""

    root: Digest  # a glue.Deferred of the device root until a prove's proof is materialized
    num_vars: int
    num_polys: int = 1  # always 1 here; kept so proofs lower as the JAX package's do
    is_trivial: bool = False


@dataclasses.dataclass
class CommitmentWithWitness:
    """Prover-side commitment: codeword + Merkle tree + bit-reversed evals."""

    commitment: BasefoldCommitment
    codeword: object
    bh_evals: list
    tree: MerkleTree

    @property
    def num_vars(self) -> int:
        return self.commitment.num_vars

    def codeword_size(self) -> int:
        return self.codeword.shape[-1]


def _encode(params: BasefoldParams, evals) -> tuple:
    """evals (little-endian) -> (bit-reversed evals, bit-reversed codeword)."""
    lg_n = evals.shape[0].bit_length() - 1
    rev_coeffs = ntt.bit_reverse(ntt.interpolate_over_hypercube(evals), lg_n)
    codeword = ntt.encode_rs(rev_coeffs, params.max_message_size_log, params.rate_log)
    codeword = ntt.bit_reverse(codeword, lg_n + params.rate_log)
    return ntt.bit_reverse(evals, lg_n), codeword


def commit(params: BasefoldParams, evals: torch.Tensor) -> CommitmentWithWitness:
    """Commit to one base polynomial given its little-endian hypercube evals."""
    return commit_many(params, [evals])[0]


def commit_many(params: BasefoldParams, evals_list, host_roots: bool = True) -> list:
    """`commit` of each polynomial; the Merkle trees of codewords of one
    size are built together (`MerkleTree.from_leaves_many`). The roots are
    read to the host in one copy, or with `host_roots=False` stay on the
    device as `glue.Deferred` nodes that `glue.materialize` lowers to
    digests with the rest of the proof (a prove's witness commitments,
    which its proof carries and its transcript does not absorb)."""
    words = []
    for evals in evals_list:
        lg_n = evals.shape[0].bit_length() - 1
        assert lg_n <= params.max_message_size_log
        if lg_n <= params.basecode_msg_size_log:
            words.append((lg_n, True, evals, evals))
        else:
            words.append((lg_n, False, *_encode(params, evals)))
    trees = MerkleTree.from_leaves_many([codeword for *_, codeword in words])
    if not trees:
        return []
    if host_roots:
        roots = [tuple(r) for r in gf.to_u64(torch.stack([t.root_dev for t in trees])).tolist()]
    else:
        roots = [glue.Deferred(t.root_dev, tuple) for t in trees]
    return [
        CommitmentWithWitness(
            BasefoldCommitment(root=root, num_vars=lg_n, is_trivial=trivial),
            codeword=codeword, bh_evals=[bh], tree=tree,
        )
        for (lg_n, trivial, bh, codeword), tree, root in zip(words, trees, roots)
    ]


def write_commitment(cm: BasefoldCommitment, transcript):
    """Absorb the 4 root elements."""
    transcript.append_field_elements(np.asarray(cm.root, dtype=np.uint64))


# ---------------------------------------------------------------------------
# commit phase
# ---------------------------------------------------------------------------


def _sumcheck_first_round(eq: GF2, evals) -> GF2:
    """Coefficient-form degree-2 message (c0, c1, c2) of sum eq * evals; a
    slice of 2 gf.CHUNK entries at a time when longer (the sums are exact,
    so the order does not matter)."""
    step = 2 * gf.CHUNK
    if eq.shape[0] > step:
        parts = [_sumcheck_first_round(eq[i : i + step], evals[i : i + step]) for i in range(0, eq.shape[0], step)]
        return gf.ext_sum_axis(gf.ext_stack(parts), 0)
    e_lo, e_hi = eq[0::2], eq[1::2]
    e_c1 = gf.ext_sub(e_hi, e_lo)
    f_lo, f_hi = evals[0::2], evals[1::2]
    if isinstance(evals, GF2):
        f_c1 = gf.ext_sub(f_hi, f_lo)
        c0 = gf.ext_mul(f_lo, e_lo)
        c1 = gf.ext_add(gf.ext_mul(f_c1, e_lo), gf.ext_mul(f_lo, e_c1))
        c2 = gf.ext_mul(f_c1, e_c1)
    else:
        f_c1 = gf.sub(f_hi, f_lo)
        c0 = gf.ext_mul_base(e_lo, f_lo)
        c1 = gf.ext_add(gf.ext_mul_base(e_lo, f_c1), gf.ext_mul_base(e_c1, f_lo))
        c2 = gf.ext_mul_base(e_c1, f_c1)
    return gf.ext_stack([gf.ext_sum_axis(c, 0) for c in (c0, c1, c2)])


def _fri_fold(oracle, r: GF2, x0: torch.Tensor, w: torch.Tensor) -> GF2:
    """new[j] = lo + (r - x0[j]) * w[j] * (hi - lo)."""
    lo, hi = oracle[0::2], oracle[1::2]
    coeff = gf.ext_mul_base(GF2(gf.sub(r.a0, x0), r.a1.expand(x0.shape)), w)
    if isinstance(oracle, GF2):
        return gf.ext_add(lo, gf.ext_mul(coeff, gf.ext_sub(hi, lo)))
    return gf.ext_add(gf.ext_from_base(lo), gf.ext_mul_base(coeff, gf.sub(hi, lo)))


def _commit_phase_session(
    params, point: GF2, running_evals, codeword, dt, num_vars, num_rounds,
    oracle_merger=None,
):
    """Shared commit phase. Returns (trees, msgs, roots, final_message);
    `oracle_merger(i, oracle)` lets batch_open add codewords after a fold.
    `codeword` may be a function giving (running_evals, codeword): a batch's
    arrays, made here so that no other name holds them past their first
    fold."""
    device = point.device
    if callable(codeword):
        running_evals, codeword = codeword()
    eq = mle_mod.eq_table(point, reverse=True)  # bit-reversed eq table
    msg = _sumcheck_first_round(eq, running_evals)
    trees, msgs, roots = [], [], []
    oracle = codeword
    del codeword
    label = (label_chunks(COMMIT_ROUND_LABEL),)
    for i in range(num_rounds):
        msgs.append(msg)
        r = dt.step(arr=msg, labels=label, k=1).reshape(())
        if i < num_rounds - 1:
            if oracle_merger is not None and i > 0:
                oracle = oracle_merger(i, oracle)
            level = oracle.shape[0].bit_length() - 2
            x0, w = params.fold_coeffs_device(level, device)
            oracle = _fri_fold(oracle, r, x0, w)
            eq = mle_mod.fix_variable(eq, r)
            running_evals = mle_mod.fix_variable(running_evals, r)
            msg = _sumcheck_first_round(eq, running_evals)
            tree = MerkleTree.from_leaves(oracle)
            trees.append(tree)
            roots.append(tree.root_dev)  # absorbed from the device, lowered at the end
            dt.append_base(tree.root_dev)
        else:
            running_evals = mle_mod.fix_variable(running_evals, r)
            k = running_evals.shape[0].bit_length() - 1
            fm = gf.to_ext(ntt.bit_reverse(running_evals, k) if k > 0 else running_evals)
            dt.append_exts(fm)
    return trees, msgs, roots, fm


def _sample_queries(params: BasefoldParams, transcript, size: int) -> list[int]:
    return [
        transcript.get_and_append_challenge(QUERY_LABEL)[0] % size
        for _ in range(params.num_queries)
    ]


def _sample_queries_session(params: BasefoldParams, dt, size: int) -> list[int]:
    """The query indices: the one host read of an opening."""
    return [c[0] % size for c in dt.challenges_to_host(QUERY_LABEL, params.num_queries)]


# ---------------------------------------------------------------------------
# single-poly open
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class QueryOpening:
    """One query: pair openings + Merkle paths through all oracles."""

    commitment_pair: tuple
    commitment_path: np.ndarray
    oracle_pairs: list
    oracle_paths: list


@dataclasses.dataclass
class BasefoldProof:
    sumcheck_messages: list
    roots: list
    final_message: list
    query_indices: list = dataclasses.field(default_factory=list)
    queries: list = dataclasses.field(default_factory=list)
    trivial_evals: list = dataclasses.field(default_factory=list)
    batch_sumcheck: object = None

    @property
    def is_trivial(self) -> bool:
        return len(self.trivial_evals) > 0


def _query_openings(comm_items, trees, indices, device, single: bool) -> list:
    """Pair openings + Merkle paths at the query indices, gathered on the
    device and pulled in one copy. comm_items: (codeword, tree, shift) per
    commitment, opened at pair index >> shift; fold tree t at >> (t + 2).
    `single` gives a single-poly proof's unlisted commitment entries."""
    q = len(indices)
    idx0 = torch.as_tensor(indices, dtype=torch.int64, device=device)
    items = comm_items + [(t.leaves, t, t_i + 2) for t_i, t in enumerate(trees)]
    entries = []
    for cw, tree, shift in items:
        take = idx0 >> shift
        paths = (
            np.empty((q, 0, 4), dtype=np.uint64)
            if tree.depth == 0
            else glue.NpGF(tree.paths_dev(take))
        )
        entries.append([cw[2 * take], cw[2 * take + 1], paths])
    n = len(comm_items)

    def build(host_entries):
        comm_h, per_tree = host_entries[:n], host_entries[n:]
        out = []
        for qi in range(q):
            pairs = [(c[0][qi], c[1][qi]) for c in comm_h]
            paths = [c[2][qi] for c in comm_h]
            out.append(
                QueryOpening(
                    commitment_pair=pairs[0] if single else pairs,
                    commitment_path=paths[0] if single else paths,
                    oracle_pairs=[(t[0][qi], t[1][qi]) for t in per_tree],
                    oracle_paths=[t[2][qi] for t in per_tree],
                )
            )
        return out

    return glue.Deferred(entries, build)


def open_session(params, comm: CommitmentWithWitness, point: GF2, dt) -> BasefoldProof:
    """Single-poly opening against a session transcript; the proof holds
    device values (glue.materialize lowers them)."""
    if comm.commitment.is_trivial:
        return BasefoldProof([], [], [], trivial_evals=[comm.bh_evals[0]])
    num_vars = comm.num_vars
    num_rounds = num_vars - params.basecode_msg_size_log
    trees, msgs, roots, fm = _commit_phase_session(
        params, point, comm.bh_evals[0], comm.codeword, dt, num_vars, num_rounds
    )
    indices = _sample_queries_session(params, dt, comm.codeword_size())
    queries = _query_openings(
        [(comm.codeword, comm.tree, 1)], trees, indices, point.device, single=True
    )
    return BasefoldProof(msgs, roots, fm, indices, queries)


def open(params, comm, point, transcript) -> BasefoldProof:
    """Single-poly opening with a host transcript (point: GF2 (n,) or host
    pairs); returns a host proof."""
    from ..transcript.session import DeviceTranscript

    device = comm.codeword.device
    if not isinstance(point, GF2):
        point = gf.ext_from_pairs(point, device)
    dt = DeviceTranscript.from_host(transcript, device)
    return dt.materialize(open_session(params, comm, point, dt), transcript)


# ---------------------------------------------------------------------------
# host-side verification helpers
# ---------------------------------------------------------------------------


def _deg2_eval(msg: list[ExtPair], x: ExtPair) -> ExtPair:
    """c0 + c1 x + c2 x^2 (coefficient form)."""
    acc = host.ext_add(host.ext_mul(msg[2], x), msg[1])
    return host.ext_add(host.ext_mul(acc, x), msg[0])


def _deg2_zero_plus_one(msg: list[ExtPair]) -> ExtPair:
    return host.ext_add(host.ext_add(msg[0], msg[0]), host.ext_add(msg[1], msg[2]))


def _interp_bh_host(v: np.ndarray) -> np.ndarray:
    """Hypercube interpolation on host ext pairs (n, 2): per variable, hi -= lo."""
    v = v.copy()
    lg_n = v.shape[0].bit_length() - 1
    for i in range(lg_n):
        half = 1 << i
        w = v.reshape(-1, 2 * half, 2)
        w[:, half:] = host.ext_sub_v(w[:, half:], w[:, :half])
    return v


def _coset_fft_host(v: np.ndarray, shift: int, lg_n: int) -> np.ndarray:
    """Host coset FFT of ext values (n, 2) - the final message is small."""
    sp = ntt._shift_powers_host(int(shift), v.shape[0])
    v = np.stack([host.mul(v[:, 0], sp), host.mul(v[:, 1], sp)], axis=-1)
    v = v[bit_reverse_perm(lg_n)]
    rows = ntt._root_rows_host(lg_n)
    for lg_m in range(1, lg_n + 1):
        half = 1 << (lg_m - 1)
        w = v.reshape(-1, 2 * half, 2)
        u, t_in = w[:, :half], w[:, half:]
        om = rows[lg_m - 1][:half, None]
        t = np.stack(
            [host.mul(t_in[..., 0], om[..., 0]), host.mul(t_in[..., 1], om[..., 0])],
            axis=-1,
        )
        v = np.concatenate([host.ext_add_v(u, t), host.ext_sub_v(u, t)], axis=1).reshape(-1, 2)
    return v


def _encode_final_message_host(params: BasefoldParams, final_message: list[ExtPair]):
    """Re-encode the final message as the verifier does: pad the bit-reversed
    coeffs to the rate, coset-FFT, bit-reverse."""
    k = len(final_message).bit_length() - 1
    fm = np.asarray([[m[0] % host.P, m[1] % host.P] for m in final_message], dtype=np.uint64)
    coeffs = _interp_bh_host(fm)[bit_reverse_perm(k)]
    n_out = len(final_message) << params.rate_log
    padded = np.zeros((n_out, 2), dtype=np.uint64)
    padded[: coeffs.shape[0]] = coeffs
    shift = host.pow_const(
        np.uint64(host.MULTIPLICATIVE_GENERATOR), 1 << (params.max_message_size_log - k)
    )
    cw = _coset_fft_host(padded, int(shift), k + params.rate_log)
    cw = cw[bit_reverse_perm(k + params.rate_log)]
    return [(int(a), int(b)) for a, b in cw]


def _eq_table_host(point: list[ExtPair]) -> list[ExtPair]:
    table = [(1, 0)]
    for r in point:
        hi = [host.ext_mul(t, r) for t in table]
        lo = [host.ext_sub(t, h) for t, h in zip(table, hi)]
        table = lo + hi
    return table


def _ext_np(pairs) -> np.ndarray:
    return np.asarray(pairs, dtype=np.uint64)


def _trivial_root_host(evals) -> Digest:
    """Merkle root of a trivial commitment on the host."""
    e = np.asarray(evals, dtype=np.uint64)
    n = e.shape[0]
    if n == 1:
        return (int(e[0]), 0, 0, 0)
    zeros = np.zeros(n // 2, dtype=np.uint64)
    d = np.stack([e[0::2], e[1::2], zeros, zeros], axis=-1)
    while d.shape[0] > 1:
        d = poseidon2.compress_host(d[0::2], d[1::2])
    return tuple(int(x) for x in d[0])


class PathJobs:
    """Deferred Merkle path checks, walked in ONE per-level batched pass over
    every tree of a verification through `compress_level` (the kernel on a
    CUDA device, its plain version on the CPU)."""

    def __init__(self, device):
        self.device = device_mod.resolve(device)
        self.jobs = []

    def add(self, leaf_digests, idxs, paths, root, label: str):
        self.jobs.append(
            (
                np.asarray(leaf_digests, dtype=np.uint64),
                np.asarray(idxs, dtype=np.int64).copy(),
                np.asarray(paths, dtype=np.uint64),
                np.asarray(root, dtype=np.uint64),
                label,
            )
        )

    def run(self):
        if not self.jobs:
            return
        d = np.concatenate([j[0] for j in self.jobs])
        ii = np.concatenate([j[1] for j in self.jobs])
        depths = np.concatenate(
            [np.full(j[0].shape[0], j[2].shape[1], dtype=np.int64) for j in self.jobs]
        )
        max_d = int(depths.max())
        n = d.shape[0]
        paths = np.zeros((n, max_d, 4), dtype=np.uint64)
        off = 0
        for j in self.jobs:
            k = j[0].shape[0]
            paths[off : off + k, : j[2].shape[1]] = j[2]
            off += k
        d = self._walk(d, paths, ii, depths, max_d)
        off = 0
        for ld, _, _, root, label in self.jobs:
            k = ld.shape[0]
            assert np.array_equal(d[off : off + k], np.broadcast_to(root, (k, 4))), label
            off += k
        self.jobs = []

    def _walk(self, d, paths, ii, depths, max_d) -> np.ndarray:
        """All rows per level at once; rows past their depth carry through."""
        dev = self.device
        d_t = gf.from_u64(d, dev).T  # (4, N)
        paths_t = gf.from_u64(paths, dev)  # (N, max_d, 4)
        ii_t = torch.as_tensor(ii, device=dev)
        depths_t = torch.as_tensor(depths, device=dev)
        for lvl in range(max_d):
            sib = paths_t[:, lvl, :].T
            odd = (ii_t & 1).bool()
            left = torch.where(odd, sib, d_t)
            right = torch.where(odd, d_t, sib)
            pairs = torch.stack([left, right], dim=2).reshape(4, -1)
            parent = compress_level(pairs)
            d_t = torch.where(depths_t > lvl, parent, d_t)
            ii_t = ii_t >> 1
        return gf.to_u64(d_t.T.contiguous()).copy()


def _verify_fold_chain_batch(
    params, queries, idx_pairs, fold_challenges, num_rounds, start_level,
    final_codeword, roots, cur_lo, cur_hi, jobs, merge_fn=None,
):
    """All queries' fold chains at once (the re-fold check)."""
    q_n = len(queries)
    idxs = np.asarray(idx_pairs, dtype=np.int64).copy()
    level = start_level
    fc = _ext_np(final_codeword)
    zeros = np.zeros(q_n, dtype=np.uint64)
    for rnd in range(num_rounds):
        x0s, ws = params.fold_coeffs_at(level, idxs)
        x0 = np.stack([x0s, zeros], axis=-1)
        w = np.stack([ws, zeros], axis=-1)
        r = np.broadcast_to(_ext_np([fold_challenges[rnd]]), (q_n, 2))
        folded = host.ext_add_v(
            cur_lo,
            host.ext_mul_v(
                host.ext_mul_v(host.ext_sub_v(r, x0), w), host.ext_sub_v(cur_hi, cur_lo)
            ),
        )
        if rnd == num_rounds - 1:
            assert np.array_equal(folded, fc[idxs]), "final codeword mismatch"
            return
        nxt = idxs >> 1
        op = np.asarray([q.oracle_pairs[rnd] for q in queries], dtype=np.uint64)
        o_lo, o_hi = op[:, 0, :], op[:, 1, :]
        got = np.where((idxs & 1).astype(bool)[:, None], o_hi, o_lo)
        assert np.array_equal(folded, got), f"fold chain mismatch round {rnd}"
        ld = np.stack([o_lo[:, 0], o_lo[:, 1], o_hi[:, 0], o_hi[:, 1]], axis=-1)
        paths = np.stack([np.asarray(q.oracle_paths[rnd], dtype=np.uint64) for q in queries])
        jobs.add(ld, nxt, paths, roots[rnd], f"oracle path {rnd}")
        cur_lo, cur_hi = o_lo, o_hi
        if merge_fn is not None:
            cur_lo, cur_hi = merge_fn(rnd, cur_lo, cur_hi)
        idxs = nxt
        level -= 1


def _check_commit_rounds(params, proof, transcript, num_vars):
    """Replay the commit-phase and query transcript; returns fold challenges."""
    num_rounds = num_vars - params.basecode_msg_size_log
    fold_challenges: list[ExtPair] = []
    for i in range(num_rounds):
        transcript.append_field_element_exts(proof.sumcheck_messages[i])
        fold_challenges.append(transcript.get_and_append_challenge(COMMIT_ROUND_LABEL))
        if i < num_rounds - 1:
            transcript.append_field_elements(np.asarray(proof.roots[i], dtype=np.uint64))
    transcript.append_field_element_exts(proof.final_message)
    indices = _sample_queries(params, transcript, 1 << (num_vars + params.rate_log))
    assert indices == proof.query_indices, "query indices mismatch"
    return fold_challenges


def _check_final(params, proof, fold_challenges, point, num_vars):
    """Sumcheck chain across rounds + the final-message inner product."""
    for i in range(len(fold_challenges) - 1):
        assert _deg2_eval(proof.sumcheck_messages[i], fold_challenges[i]) == (
            _deg2_zero_plus_one(proof.sumcheck_messages[i + 1])
        ), f"sumcheck chain round {i}"
    num_rounds = len(fold_challenges)
    coeff = host.ext_eq_eval(point[num_vars - num_rounds :], list(reversed(fold_challenges)))
    eq_low = _eq_table_host(point[: num_vars - num_rounds])
    total = (0, 0)
    for m, e in zip(proof.final_message, eq_low, strict=True):
        total = host.ext_add(total, host.ext_mul(m, host.ext_mul(e, coeff)))
    assert _deg2_eval(proof.sumcheck_messages[-1], fold_challenges[-1]) == total, (
        "final message inner product"
    )


def verify(params, commitment, point: list[ExtPair], eval_: ExtPair, proof, transcript, device="cuda"):
    """Single-poly verification; raises AssertionError on a bad proof. The
    Merkle paths are walked on `device`."""
    if proof.is_trivial:
        evals = np.asarray(proof.trivial_evals[0], dtype=np.uint64)
        assert _trivial_root_host(evals) == tuple(commitment.root), "trivial root mismatch"
        assert host.mle_eval_v(evals, point) == eval_, "trivial eval mismatch"
        return
    num_vars = len(point)
    assert num_vars == commitment.num_vars
    fold_challenges = _check_commit_rounds(params, proof, transcript, num_vars)
    final_codeword = _encode_final_message_host(params, proof.final_message)

    q_n = len(proof.query_indices)
    pairs = np.asarray(proof.query_indices, dtype=np.int64) >> 1
    cp = np.asarray([q.commitment_pair for q in proof.queries], dtype=np.uint64)
    zeros = np.zeros(q_n, dtype=np.uint64)
    jobs = PathJobs(device)
    jobs.add(
        np.stack([cp[:, 0], cp[:, 1], zeros, zeros], axis=-1),
        pairs,
        np.stack([np.asarray(q.commitment_path, dtype=np.uint64) for q in proof.queries]),
        commitment.root,
        "commitment path",
    )
    _verify_fold_chain_batch(
        params, proof.queries, pairs, fold_challenges, len(fold_challenges),
        num_vars + params.rate_log - 1, final_codeword, proof.roots,
        np.stack([cp[:, 0], zeros], axis=-1), np.stack([cp[:, 1], zeros], axis=-1), jobs,
    )
    jobs.run()
    assert eval_ == _deg2_zero_plus_one(proof.sumcheck_messages[0]), "claimed eval"
    _check_final(params, proof, fold_challenges, point, num_vars)


# ---------------------------------------------------------------------------
# batch open / verify
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchEvaluation:
    poly: int
    point: int
    value: object


def batch_open_session(params, polys, comms, points, evals, dt) -> BasefoldProof:
    """Batched opening of many (poly, point, eval) triples:
      1. b"batch coeffs" challenges t, eq_t table;
      2. sumcheck of sum_x sum_pt eq(x, point_pt) merged_pt(x) (merged_pt =
         sum eq_t[i] poly_i; a point's eq and merged rows keep their own
         length, which the sumcheck reads as their tiling over the high
         vars);
      3. per-commitment RLC coeffs eq(challenges[:n_pt], point) eq_t;
      4. batched commit phase folding codewords in at matching sizes;
      5. shared query phase over all commitments + fold trees."""
    from ..sumcheck import VirtualPolynomial, prove_device
    from ..sumcheck.fused import empty_stack

    device = dt.device
    num_vars = max(c.num_vars for c in comms)
    batch_size_log = max(1, (len(evals) - 1).bit_length()) if len(evals) > 1 else 0
    if batch_size_log:
        eq_t = mle_mod.eq_table(dt.get_and_append_challenges(b"batch coeffs", batch_size_log))
    else:
        eq_t = gf.ext_ones((1,), device)

    # each point's eq row and merged row (sum_i eq_t[i] poly_i over its
    # claims) are made in their place of the sumcheck's planes, a point at a
    # time, so the rows are not held twice
    by_point: dict = {}
    for i, ev in enumerate(evals):
        by_point.setdefault(ev.point, []).append(i)
    order = sorted(by_point)
    st = empty_stack([points[pt].shape[0] for pt in order for _ in range(2)], device)
    vp = VirtualPolynomial.new(num_vars)
    for k, pt in enumerate(order):
        eq_row, m_row = st.row(2 * k), st.row(2 * k + 1)
        _fill(eq_row, mle_mod.eq_table(points[pt]))
        merged = None
        for i in by_point[pt]:
            term = _scale(polys[evals[i].poly], eq_t[i])
            assert term.shape[0] == m_row.shape[0], "polys opened at one point must share size"
            merged = _acc(merged, term)
            del term
        _fill(m_row, merged)
        del merged
        vp.add_product((1, 0), [vp.add_mle(eq_row), vp.add_mle(m_row)])
    del eq_row, m_row
    sc_out = prove_device(vp, dt, stacked=st)
    del vp, st  # the planes: the rounds overwrote them
    challenges = sc_out.proof.point  # GF2 (num_vars,)

    coeffs = [gf.ext_zeros((), device) for _ in comms]
    for i, ev in enumerate(evals):
        n_pt = points[ev.point].shape[0]
        e = _eq_eval(challenges[:n_pt], points[ev.point])
        coeffs[ev.poly] = gf.ext_add(coeffs[ev.poly], gf.ext_mul(e, eq_t[i]))

    full_cw = 1 << (num_vars + params.rate_log)

    def oracle_and_evals():
        """The RLC of the full-size codewords and the running evaluations.
        The sums start from their first term, not from zeros: at 2^29
        entries a zero array and a sum beside each term would be two arrays
        too many; and no name here holds them past the commit phase's
        first fold."""
        oracle = run_evals = None
        for c, comm in zip(coeffs, comms):
            if comm.codeword_size() == full_cw:
                oracle = _acc(oracle, _scale(comm.codeword, c))
            # bit-reversed evals of smaller polys repeat over consecutive chunks
            reps = 1 << (num_vars - comm.num_vars)
            term = _scale(comm.bh_evals[0], c)
            if reps > 1:
                term = GF2(term.a0.repeat_interleave(reps), term.a1.repeat_interleave(reps))
            run_evals = _acc(run_evals, term)
            del term
        return run_evals, oracle

    def merger(i, oracle):
        for c, comm in zip(coeffs, comms):
            if comm.codeword_size() == oracle.shape[0]:
                oracle = gf.ext_add(oracle, _scale(comm.codeword, c))
        return oracle

    num_rounds = num_vars - params.basecode_msg_size_log
    trees, msgs, roots, fm = _commit_phase_session(
        params, challenges, None, oracle_and_evals, dt, num_vars, num_rounds,
        oracle_merger=merger,
    )
    indices = _sample_queries_session(params, dt, full_cw)
    queries = _query_openings(
        [(c.codeword, c.tree, num_vars - c.num_vars + 1) for c in comms],
        trees, indices, device, single=False,
    )
    return BasefoldProof(msgs, roots, fm, indices, queries, batch_sumcheck=sc_out.proof)


def batch_open(params, polys, comms, points, evals, transcript) -> BasefoldProof:
    """Batched opening with a host transcript (points: GF2 (n,) or host
    pairs); returns a host proof."""
    from ..transcript.session import DeviceTranscript

    device = comms[0].codeword.device
    points = [p if isinstance(p, GF2) else gf.ext_from_pairs(p, device) for p in points]
    dt = DeviceTranscript.from_host(transcript, device)
    return dt.materialize(batch_open_session(params, polys, comms, points, evals, dt), transcript)


def _fill(dst: GF2, src: GF2) -> None:
    dst.a0.copy_(src.a0)
    dst.a1.copy_(src.a1)


def _acc(total, term: GF2) -> GF2:
    return term if total is None else gf.ext_add(total, term)


def _scale(poly, c: GF2) -> GF2:
    """c * poly for a base or ext poly."""
    return gf.ext_mul(c, poly) if isinstance(poly, GF2) else gf.ext_mul_base(c, poly)


def _eq_eval(x: GF2, y: GF2) -> GF2:
    """eq(x, y) = prod_i (2 x_i y_i + 1 - x_i - y_i) for two (n,) points."""
    xy = gf.ext_mul(x, y)
    one = gf.ext_ones(x.shape, x.device)
    terms = gf.ext_add(gf.ext_add(xy, xy), gf.ext_sub(one, gf.ext_add(x, y)))
    acc = gf.ext_ones((), x.device)
    for i in range(terms.shape[0]):
        acc = gf.ext_mul(acc, terms[i])
    return acc


def batch_verify(params, commitments, points, evals, proof, transcript, device="cuda"):
    """Batched verification; raises AssertionError on a bad proof. The
    Merkle paths are walked on `device`."""
    from ..sumcheck.verifier import verify as sumcheck_verify

    num_vars = max(len(p) for p in points)
    batch_size_log = max(1, (len(evals) - 1).bit_length()) if len(evals) > 1 else 0
    ts = [transcript.get_and_append_challenge(b"batch coeffs") for _ in range(batch_size_log)]
    eq_t = _eq_table_host(ts)

    target_sum = (0, 0)
    for i, ev in enumerate(evals):
        scale = (1 << (num_vars - len(points[ev.point]))) % host.P
        target_sum = host.ext_add(
            target_sum, host.ext_mul(host.ext_mul(eq_t[i], (scale, 0)), ev.value)
        )
    sub = sumcheck_verify(
        target_sum, proof.batch_sumcheck.round_messages, num_vars, 2, transcript
    )
    challenges = sub.point

    coeffs = [(0, 0)] * len(commitments)
    for i, ev in enumerate(evals):
        n_pt = len(points[ev.point])
        e = host.ext_eq_eval(challenges[:n_pt], points[ev.point])
        coeffs[ev.poly] = host.ext_add(coeffs[ev.poly], host.ext_mul(e, eq_t[i]))

    fold_challenges = _check_commit_rounds(params, proof, transcript, num_vars)
    final_codeword = _encode_final_message_host(params, proof.final_message)
    assert sub.expected_evaluation == _deg2_zero_plus_one(proof.sumcheck_messages[0]), (
        "batch claim mismatch"
    )

    q_n = len(proof.query_indices)
    idx_arr = np.asarray(proof.query_indices, dtype=np.int64)
    zeros = np.zeros(q_n, dtype=np.uint64)
    cp_all = np.asarray([q.commitment_pair for q in proof.queries], dtype=np.uint64)
    jobs = PathJobs(device)
    for ci, cm in enumerate(commitments):
        paths = np.stack(
            [np.asarray(q.commitment_path[ci], dtype=np.uint64) for q in proof.queries]
        )
        jobs.add(
            np.stack([cp_all[:, ci, 0], cp_all[:, ci, 1], zeros, zeros], axis=-1),
            (idx_arr >> (num_vars - cm.num_vars)) >> 1,
            paths,
            cm.root,
            f"commitment {ci} path",
        )

    def rlc_at(size_vars, cur_lo, cur_hi):
        """Merge the openings of commitments whose codeword has this size."""
        for ci, (cm, c) in enumerate(zip(commitments, coeffs)):
            if cm.num_vars == size_vars:
                cv = np.broadcast_to(_ext_np([c]), (q_n, 2))
                lo_p = np.stack([cp_all[:, ci, 0], zeros], axis=-1)
                hi_p = np.stack([cp_all[:, ci, 1], zeros], axis=-1)
                cur_lo = host.ext_add_v(cur_lo, host.ext_mul_v(cv, lo_p))
                cur_hi = host.ext_add_v(cur_hi, host.ext_mul_v(cv, hi_p))
        return cur_lo, cur_hi

    cur_lo, cur_hi = rlc_at(
        num_vars, np.zeros((q_n, 2), dtype=np.uint64), np.zeros((q_n, 2), dtype=np.uint64)
    )
    _verify_fold_chain_batch(
        params, proof.queries, idx_arr >> 1, fold_challenges, len(fold_challenges),
        num_vars + params.rate_log - 1, final_codeword, proof.roots, cur_lo, cur_hi, jobs,
        merge_fn=lambda rnd, lo, hi: rlc_at(num_vars - (rnd + 1), lo, hi),
    )
    jobs.run()
    _check_final(params, proof, fold_challenges, challenges, num_vars)
