"""ConcatMatMul (a batched per-head matmul) and Permute, as in the JAX
package's `zkml/layers/concat_matmul.py`.

ConcatMatMul: C[h, m, n] = sum_k A[h, m, k] B[h, k, n] (B[h, n, k] with
transpose_b), attention's per-head Q K^T and P V. The output claim
C~(rho_n, rho_m, rho_h) reduces with one degree-3 sumcheck over (k, h):
    sum_{k,h} eq(rho_h, h) A~(k, rho_m, h) B~(rho_n, k, h)
where the m (or n) variables sit in the middle of the little-endian
layouts and are fixed by a middle-axis fold. The final evaluations are
claims on A at (k_pt, rho_m, h_pt) and B at (rho_n, k_pt, h_pt) (with
transpose_b (k_pt, rho_n, h_pt)), both witness claims for the producers.

Permute: transposing the axes of a power-of-two tensor permutes the
little-endian variable blocks of its MLE, so a claim on the output is a
claim on the input with its point's blocks reordered; no sumcheck.
"""

from __future__ import annotations

import dataclasses

import torch

from ... import glue
from ...fields import host
from ...fields.gf import GF2
from ...lookup.logup import Claim
from ...poly import mle as mle_mod
from ...sumcheck import VirtualPolynomial, prove_device
from ...sumcheck import verify as sumcheck_verify
from .. import quantization as Q
from ..tensor import Tensor, ceil_log2


def _take(values, axis: int, i: int):
    """values[..., i, ...] along `axis` for a base tensor or GF2."""
    if isinstance(values, GF2):
        return GF2(values.a0.select(axis, i), values.a1.select(axis, i))
    return values.select(axis, i)


def fix_axis(values, point: GF2, shape: tuple, axis: int):
    """Fold `point` into one axis of a row-major multi-dim MLE (its low bit
    first); returns the flat extension MLE with that axis gone."""
    cur = values.reshape(*shape)
    for i in range(point.shape[0]):
        sh = tuple(cur.shape)
        pairs = cur.reshape(*sh[:axis], sh[axis] // 2, 2, *sh[axis + 1 :])
        cur = mle_mod.fold(_take(pairs, axis + 1, 0), _take(pairs, axis + 1, 1), point[i])
    return cur.reshape(-1)


@dataclasses.dataclass
class ConcatMatMul:
    """C[h, m, n] = sum_k A[h, m, k] B[h, k, n]; transpose_b: B[h, n, k]."""

    transpose_b: bool = False

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        a, b = (t.data.to(torch.int64) for t in inputs)
        assert a.dim() == 3 and b.dim() == 3
        if self.transpose_b:
            b = b.transpose(1, 2)
        # products and a sum over k (CUDA has no integer matmul)
        return [Tensor((a[:, :, :, None] * b[:, None, :, :]).sum(dim=2))]

    def output_bitsize(self) -> int:
        return 2 * (Q.BIT_LEN - 1) + 14

    def step_info(self, node_id: int, aux):
        return ConcatMatMulCtx(node_id=node_id, transpose_b=self.transpose_b)

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        pt = last_claims[0].point
        a, b = (t.data.to(torch.int64) for t in step_data.inputs)
        h, m, k = a.shape
        h2, n, k2 = b.shape if self.transpose_b else (b.shape[0], b.shape[2], b.shape[1])
        assert h == h2 and k == k2
        assert all(x & (x - 1) == 0 for x in (h, m, k, n)), "pow2 dims"
        lh, lm, lk, ln = (ceil_log2(x) for x in (h, m, k, n))
        assert pt.shape[0] == ln + lm + lh
        rho_n, rho_m, rho_h = pt[:ln], pt[ln : ln + lm], pt[ln + lm :]

        # A (h, m, k): fix m -> (h, k), k low; B (h, n, k) or (h, k, n): fix n
        a_fixed = fix_axis(Q.to_field(a.reshape(-1)), rho_m, (h, m, k), 1)
        if self.transpose_b:
            b_fixed = fix_axis(Q.to_field(b.reshape(-1)), rho_n, (h, n, k), 1)
        else:
            b_fixed = fix_axis(Q.to_field(b.reshape(-1)), rho_n, (h, k, n), 2)
        eq_h = mle_mod.eq_table(rho_h)
        eq_rep = GF2(eq_h.a0.repeat_interleave(k), eq_h.a1.repeat_interleave(k))  # (h k,), k low

        vp = VirtualPolynomial.new(lk + lh)
        vp.add_product((1, 0), [vp.add_mle(eq_rep), vp.add_mle(a_fixed), vp.add_mle(b_fixed)])
        out = prove_device(vp, prover.dt)
        s = out.proof.point
        k_pt, h_pt = s[:lk], s[lk:]
        a_point = glue.concat_points([k_pt, rho_m, h_pt])
        b_point = glue.concat_points([k_pt, rho_n, h_pt] if self.transpose_b else [rho_n, k_pt, h_pt])
        prover.push_proof(
            node_id,
            ConcatMatMulProof(sumcheck=out.proof, individual_claims=out.final_evals, dims=(lh, lm, lk, ln)),
        )
        return [glue.DevClaim(point=a_point, eval=glue.at(out.final_evals, 1)),
                glue.DevClaim(point=b_point, eval=glue.at(out.final_evals, 2))]


@dataclasses.dataclass
class ConcatMatMulProof:
    sumcheck: object
    individual_claims: object  # [eq_h, A, B]
    dims: tuple  # (lh, lm, lk, ln)


@dataclasses.dataclass
class ConcatMatMulCtx:
    node_id: int
    transpose_b: bool

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof: ConcatMatMulProof, last_claims, verifier) -> list[Claim]:
        last_claim = last_claims[0]
        lh, lm, lk, ln = proof.dims
        pt = list(last_claim.point)
        rho_n, rho_m, rho_h = pt[:ln], pt[ln : ln + lm], pt[ln + lm :]
        sub = sumcheck_verify(last_claim.eval, proof.sumcheck.round_messages, lk + lh, 3, verifier.transcript)
        s = list(sub.point)
        k_pt, h_pt = s[:lk], s[lk:]
        f = proof.individual_claims
        eq_eval = host.ext_eq_eval(rho_h, h_pt)
        assert host.ext_mul(host.ext_mul(eq_eval, f[1]), f[2]) == sub.expected_evaluation, (
            "concat_matmul sumcheck mismatch"
        )
        assert f[0] == eq_eval, "concat_matmul eq claim mismatch"
        b_point = (k_pt + rho_n + h_pt) if self.transpose_b else (rho_n + k_pt + h_pt)
        return [Claim(point=k_pt + rho_m + h_pt, eval=f[1]), Claim(point=b_point, eval=f[2])]


def _blocks(shape) -> list:
    """(offset, bits) of each axis's little-endian variable block (the last
    axis lowest), indexed by axis."""
    offs, off = [], 0
    for b in reversed([ceil_log2(d) for d in shape]):
        offs.append((off, b))
        off += b
    return list(reversed(offs))


def rewire_point(point, perm, in_shape):
    """A claim point on transpose(x, perm) as a point on x: the input's
    blocks from its last axis (low variables) up, each the output block of
    the axis that `perm` moved it to. A device GF2 or a host list."""
    out_blocks = _blocks(tuple(in_shape[a] for a in perm))
    parts = []
    for in_axis in reversed(range(len(in_shape))):
        off, nb = out_blocks[list(perm).index(in_axis)]
        parts.append(point[off : off + nb])
    if isinstance(point, GF2):
        return glue.concat_points(parts)
    return [p for blk in parts for p in blk]


@dataclasses.dataclass
class Permute:
    """out = transpose(in viewed as in_shape, perm); every dim a power of two."""

    perm: tuple
    in_shape: tuple

    @property
    def is_provable(self) -> bool:
        return True

    def evaluate(self, inputs: list[Tensor]) -> list[Tensor]:
        x = inputs[0].data.reshape(self.in_shape)
        assert all(d & (d - 1) == 0 for d in x.shape), "pow2 dims"
        return [Tensor(x.permute(*self.perm).contiguous())]

    def step_info(self, node_id: int, aux):
        out_shape = tuple(self.in_shape[a] for a in self.perm)
        return PermuteCtx(node_id=node_id, perm=tuple(self.perm), in_shape=tuple(self.in_shape), out_shape=out_shape)

    def prove(self, node_id, ctx, last_claims, step_data, prover):
        point = rewire_point(last_claims[0].point, self.perm, tuple(self.in_shape))
        prover.push_proof(node_id, PermuteProof())
        return [glue.DevClaim(point=point, eval=last_claims[0].eval)]


@dataclasses.dataclass
class PermuteProof:
    pass


@dataclasses.dataclass
class PermuteCtx:
    node_id: int
    perm: tuple
    in_shape: tuple = None
    out_shape: tuple = None

    @property
    def is_provable(self) -> bool:
        return True

    def verify(self, proof, last_claims, verifier) -> list[Claim]:
        point = rewire_point(list(last_claims[0].point), self.perm, self.in_shape)
        return [Claim(point=point, eval=last_claims[0].eval)]
