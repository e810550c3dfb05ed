"""GPT-2: configuration, weights, float calibration, the provable graph
and the generation loop, as in the JAX package's `zkml/llm.py`.

The host part is numpy, copied: the synthetic weights, the float forward
that calibrates every activation's scale, and the quantization helpers
(float64, round half to even). `GPT2Builder.build` makes the whole graph
on the builder's device: Embeddings -> Positional, then a block's
attention half (LayerNorm -> Requant -> QKV -> three Requants -> Permute
-> ConcatMatMul (Q K^T) -> Softmax -> ConcatMatMul (P V) -> Permute ->
Reshape -> Requant -> MatMul -> Requant -> Add (the residual) -> Requant)
and its feed-forward half (LayerNorm -> Requant -> MatMul (up, with bias)
-> Requant -> Gelu -> MatMul (down) -> Requant -> Add -> Requant), then
the final LayerNorm, the lm_head and Logits. `Driver` runs (and proves)
one full-context inference a token. The GGUF loader is not ported yet
(ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from . import quantization as Q
from .layers.activation import Gelu
from .layers.add import Add
from .layers.concat_matmul import ConcatMatMul, Permute
from .layers.embeddings import Embeddings, Positional
from .layers.layernorm import LayerNorm
from .layers.logits import Logits
from .layers.matmul import MatMul
from .layers.qkv import QKV
from .layers.requant import Requant
from .layers.shape_ops import Reshape
from .layers.softmax import Softmax
from .lookup_context import LAYERNORM_OUTPUT_SCALE_FACTOR, OUTPUT_SCALE_FACTOR
from .model import Edge, Model
from .quantization import RequantSpec
from .tensor import Tensor, ceil_log2, next_pow2

_LATER = "is not ported yet: the GGUF parser arrives later (ROADMAP queue 1 item 4)"


@dataclasses.dataclass
class LLMConfig:
    """GPT-2 hyperparameters."""

    vocab: int
    emb: int
    heads: int
    blocks: int
    context: int
    eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.emb // self.heads


@dataclasses.dataclass
class GPT2Block:
    ln1_g: np.ndarray
    ln1_b: np.ndarray
    qkv_w: np.ndarray  # (emb, 3 emb)
    qkv_b: np.ndarray
    proj_w: np.ndarray  # (emb, emb)
    proj_b: np.ndarray
    ln2_g: np.ndarray
    ln2_b: np.ndarray
    up_w: np.ndarray  # (emb, 4 emb)
    up_b: np.ndarray
    down_w: np.ndarray  # (4 emb, emb)
    down_b: np.ndarray


@dataclasses.dataclass
class GPT2Weights:
    """Float weights, laid out for x @ W (+ b), W (in, out)."""

    config: LLMConfig
    wte: np.ndarray  # (vocab, emb)
    wpe: np.ndarray  # (context, emb)
    blocks: list
    lnf_g: np.ndarray
    lnf_b: np.ndarray
    lm_head: np.ndarray  # (emb, vocab)

    @staticmethod
    def from_gguf(g) -> "GPT2Weights":
        raise NotImplementedError(f"GPT2Weights.from_gguf {_LATER}")

    @staticmethod
    def synthetic(config: LLMConfig, seed: int = 0) -> "GPT2Weights":
        """Random GPT-2-shaped weights, in the JAX package's draw order."""
        rng = np.random.default_rng(seed)
        c = config

        def n(*s):
            return rng.normal(0, 0.35, size=s)

        blocks = [
            GPT2Block(
                ln1_g=n(c.emb) * 0.2 + 1.0, ln1_b=n(c.emb) * 0.1,
                qkv_w=n(c.emb, 3 * c.emb), qkv_b=n(3 * c.emb) * 0.1,
                proj_w=n(c.emb, c.emb), proj_b=n(c.emb) * 0.1,
                ln2_g=n(c.emb) * 0.2 + 1.0, ln2_b=n(c.emb) * 0.1,
                up_w=n(c.emb, 4 * c.emb), up_b=n(4 * c.emb) * 0.1,
                down_w=n(4 * c.emb, c.emb), down_b=n(c.emb) * 0.1,
            )
            for _ in range(c.blocks)
        ]
        return GPT2Weights(
            config=c, wte=n(c.vocab, c.emb), wpe=n(c.context, c.emb) * 0.3, blocks=blocks,
            lnf_g=n(c.emb) * 0.2 + 1.0, lnf_b=n(c.emb) * 0.1, lm_head=n(c.emb, c.vocab),
        )


def _gelu(x):
    return 0.5 * x * (1.0 + np.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def _layernorm_f(x, g, b, eps):
    mu = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return g * (x - mu) / np.sqrt(var + eps) + b


def _softmax_f(x, temp_mult):
    out = np.zeros_like(x)
    for h in range(x.shape[0]):
        for i in range(x.shape[1]):
            row = x[h, i, : i + 1] * temp_mult
            e = np.exp(row - row.max())
            out[h, i, : i + 1] = e / e.sum()
    return out


def _mx(a) -> float:
    return float(np.abs(a).max())


def _q(a: np.ndarray, scale: float) -> np.ndarray:
    return np.clip(np.round(np.asarray(a, dtype=np.float64) / scale), Q.MIN, Q.MAX).astype(np.int64)


def _ln_out_scale(gamma_f, s_in: float) -> float:
    s_gamma = max(1e-12, float(np.abs(np.asarray(gamma_f)).max())) / Q.MAX
    return s_in * s_gamma / LAYERNORM_OUTPUT_SCALE_FACTOR


def _requant(m: Model, src: int, s_before: float, s_after: float, bits: int) -> int:
    return _requant_wire(m, src, 0, s_before, s_after, bits)


def _requant_wire(m: Model, src: int, wire: int, s_before: float, s_after: float, bits: int) -> int:
    spec = RequantSpec.from_multiplier(s_before / s_after, bits)
    return m.add_node(Requant(spec=spec), [Edge(node=src, index=wire)])


def _embed_head_cols(w: np.ndarray, h: int, d: int, h_pad: int, d_pad: int) -> np.ndarray:
    """(in, h d) -> (in, h_pad d_pad): head hh's columns at hh d_pad + j,
    the pad columns zero (so pad outputs are exactly 0)."""
    out = np.zeros((w.shape[0], h_pad * d_pad), dtype=np.int64)
    for hh in range(h):
        out[:, hh * d_pad : hh * d_pad + d] = w[:, hh * d : (hh + 1) * d]
    return out


def _embed_head_vec(b: np.ndarray, h: int, d: int, h_pad: int, d_pad: int) -> np.ndarray:
    out = np.zeros(h_pad * d_pad, dtype=np.int64)
    for hh in range(h):
        out[hh * d_pad : hh * d_pad + d] = b[hh * d : (hh + 1) * d]
    return out


def _embed_head_rows(w: np.ndarray, h: int, d: int, h_pad: int, d_pad: int) -> np.ndarray:
    """(h d, out) -> (h_pad d_pad, out) with zero rows at the pad positions:
    the projection ignores the head layout's padding."""
    out = np.zeros((h_pad * d_pad, w.shape[1]), dtype=np.int64)
    for hh in range(h):
        out[hh * d_pad : hh * d_pad + d, :] = w[hh * d : (hh + 1) * d, :]
    return out


class GPT2Builder:
    """Calibrates activation scales on one token sequence (a float forward)
    and appends quantized layers, their weights on `device`, to a Model."""

    def __init__(self, weights: GPT2Weights, seq: int, device="cuda"):
        self.device = device_mod.resolve(device)
        self.w = weights
        self.c = weights.config
        self.seq = next_pow2(seq)
        assert self.seq <= self.c.context

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int64)).to(self.device)

    def _calibrate(self, tokens: np.ndarray) -> dict:
        """Every activation's absolute max in the float forward of `tokens`
        (padded with 0 to seq)."""
        w, c = self.w, self.c
        s = {}
        seq = self.seq
        toks = np.zeros(seq, dtype=np.int64)
        toks[: tokens.size] = tokens[:seq]
        x = w.wte[toks] + w.wpe[:seq]
        s["emb"] = _mx(x)
        for i, blk in enumerate(w.blocks):
            h = _layernorm_f(x, blk.ln1_g, blk.ln1_b, c.eps)
            s[f"b{i}.ln1"] = _mx(h)
            qkv = h @ blk.qkv_w + blk.qkv_b
            q, k, v = np.split(qkv, 3, axis=-1)
            s[f"b{i}.q"] = _mx(q)
            s[f"b{i}.k"] = _mx(k)
            s[f"b{i}.v"] = _mx(v)
            qh = q.reshape(seq, c.heads, c.head_dim).transpose(1, 0, 2)
            kh = k.reshape(seq, c.heads, c.head_dim).transpose(1, 0, 2)
            vh = v.reshape(seq, c.heads, c.head_dim).transpose(1, 0, 2)
            att = np.einsum("hmk,hnk->hmn", qh, kh)
            s[f"b{i}.att"] = _mx(att)
            p = _softmax_f(att, 1.0 / np.sqrt(c.head_dim))
            o = np.einsum("hmn,hnd->hmd", p, vh).transpose(1, 0, 2).reshape(seq, c.emb)
            s[f"b{i}.attn_out"] = _mx(o)
            o = o @ blk.proj_w + blk.proj_b
            s[f"b{i}.proj"] = _mx(o)
            x = x + o
            s[f"b{i}.res1"] = _mx(x)
            h = _layernorm_f(x, blk.ln2_g, blk.ln2_b, c.eps)
            s[f"b{i}.ln2"] = _mx(h)
            u = _gelu(h @ blk.up_w + blk.up_b)
            s[f"b{i}.up"] = _mx(h @ blk.up_w + blk.up_b)
            s[f"b{i}.gelu"] = _mx(u)
            d = u @ blk.down_w + blk.down_b
            s[f"b{i}.down"] = _mx(d)
            x = x + d
            s[f"b{i}.res2"] = _mx(x)
        h = _layernorm_f(x, w.lnf_g, w.lnf_b, c.eps)
        s["lnf"] = _mx(h)
        s["logits"] = _mx(h @ w.lm_head)
        return s

    def build(self, calibration_tokens: np.ndarray):
        """The whole graph, scales calibrated on `calibration_tokens`:
        returns (Model, meta), meta with the seq, the logits' scale and the
        device."""
        w, c, seq = self.w, self.c, self.seq
        sc = self._calibrate(np.asarray(calibration_tokens, dtype=np.int64))
        m = Model(num_inputs=1)
        # the embeddings and positions share one scale
        s_emb = max(_mx(w.wte), _mx(w.wpe)) / Q.MAX
        n_emb = m.add_node(Embeddings(table=self._tensor(_q(w.wte, s_emb))), [Edge(node=None, index=0)])
        x_id = m.add_node(Positional(table=self._tensor(_q(w.wpe[:seq], s_emb))), [Edge(node=n_emb, index=0)])
        s_x = s_emb
        for i, blk in enumerate(w.blocks):
            x_id, s_x = self._attention(m, x_id, s_x, blk, i, sc)
            x_id, s_x = self._ffn(m, x_id, s_x, blk, i, sc)
        # the final norm, the lm_head and the argmax
        ln = LayerNorm.from_float(w.lnf_g, w.lnf_b, c.eps, s_x, device=self.device)
        n_ln = m.add_node(ln, [Edge(node=x_id, index=0)])
        s_lnf = sc["lnf"] / Q.MAX
        n_rq = _requant(m, n_ln, _ln_out_scale(w.lnf_g, s_x), s_lnf, ln.output_bitsize())
        s_w = _mx(w.lm_head) / Q.MAX
        n_mm = m.add_node(MatMul.new_constant(self._tensor(_q(w.lm_head, s_w))), [Edge(node=n_rq, index=0)])
        s_logits = sc["logits"] / Q.MAX
        n_rq2 = _requant(m, n_mm, s_lnf * s_w, s_logits, 2 * (Q.BIT_LEN - 1) + ceil_log2(next_pow2(c.emb)) + 1)
        m.add_node(Logits(), [Edge(node=n_rq2, index=0)])
        return m, {"seq": seq, "s_logits": s_logits, "device": self.device}

    def _attention(self, m: Model, x_id: int, s_x: float, blk: GPT2Block, i: int, sc: dict) -> tuple[int, float]:
        """Append block i's attention half after node x_id (scale s_x),
        x_id feeding both the LayerNorm and the residual Add; returns (the
        last node, its scale). The q, k and v weight columns sit in an
        (h_pad, d_pad) power-of-two head layout with zero pad columns and
        biases, and the projection has zero rows there."""
        c, seq = self.c, self.seq
        h, d = c.heads, c.head_dim
        h_pad, d_pad = next_pow2(h), next_pow2(d)
        ln = LayerNorm.from_float(blk.ln1_g, blk.ln1_b, c.eps, s_x, device=self.device)
        n_ln = m.add_node(ln, [Edge(node=x_id, index=0)])
        s_h = sc[f"b{i}.ln1"] / Q.MAX
        n_h = _requant(m, n_ln, _ln_out_scale(blk.ln1_g, s_x), s_h, ln.output_bitsize())

        # one weight scale for the three projections of the shared input
        s_w = max(_mx(blk.qkv_w[:, col * c.emb : (col + 1) * c.emb]) / Q.MAX for col in range(3))
        ws, bs = [], []
        for col in range(3):
            cols = slice(col * c.emb, (col + 1) * c.emb)
            ws.append(self._tensor(_embed_head_cols(_q(blk.qkv_w[:, cols], s_w), h, d, h_pad, d_pad)))
            bs.append(self._tensor(_embed_head_vec(_q(blk.qkv_b[cols], s_h * s_w), h, d, h_pad, d_pad)))
        qkv = QKV(ws=ws, bs=bs)
        n_qkv = m.add_node(qkv, [Edge(node=n_h, index=0)])
        heads, scales = {}, {}
        for wire, name in enumerate(("q", "k", "v")):
            scales[name] = sc[f"b{i}.{name}"] / Q.MAX
            n_rq = _requant_wire(m, n_qkv, wire, s_h * s_w, scales[name], qkv.output_bitsize())
            # (seq, h_pad d_pad) as (seq, h_pad, d_pad) -> (h_pad, seq, d_pad)
            heads[name] = m.add_node(Permute((1, 0, 2), (seq, h_pad, d_pad)), [Edge(node=n_rq, index=0)])

        n_qk = m.add_node(ConcatMatMul(transpose_b=True),
                          [Edge(node=heads["q"], index=0), Edge(node=heads["k"], index=0)])
        s_att = scales["q"] * scales["k"]
        att_mx = sc[f"b{i}.att"] / (s_att if s_att else 1.0)
        sm = Softmax(s_in=s_att, max_size=max(64, seq), temperature=1.0 / float(np.sqrt(d)), seq=seq,
                     domain_max=int(max(1, abs(att_mx)) * 2))
        n_sm = m.add_node(sm, [Edge(node=n_qk, index=0)])
        n_fm = m.add_node(ConcatMatMul(), [Edge(node=n_sm, index=0), Edge(node=heads["v"], index=0)])
        # (h_pad, seq, d_pad) -> (seq, h_pad, d_pad) = (seq, h_pad d_pad)
        n_pb = m.add_node(Permute((1, 0, 2), (h_pad, seq, d_pad)), [Edge(node=n_fm, index=0)])
        n_pb = m.add_node(Reshape((seq, h_pad * d_pad)), [Edge(node=n_pb, index=0)])
        s_fm = scales["v"] / OUTPUT_SCALE_FACTOR  # the probabilities' scale times the values'
        s_ao = sc[f"b{i}.attn_out"] / Q.MAX
        n_rq = _requant(m, n_pb, s_fm, s_ao, 2 * (Q.BIT_LEN - 1) + ceil_log2(OUTPUT_SCALE_FACTOR * seq) + 2)
        s_w = _mx(blk.proj_w) / Q.MAX
        mmp = MatMul.new_constant(self._tensor(_embed_head_rows(_q(blk.proj_w, s_w), h, d, h_pad, d_pad)),
                                  self._tensor(_q(blk.proj_b, s_ao * s_w)))
        n_mm = m.add_node(mmp, [Edge(node=n_rq, index=0)])
        # the projection back to the residual stream's scale s_x
        n_rqp = _requant(m, n_mm, s_ao * s_w, s_x, mmp.output_bitsize())
        n_add = m.add_node(Add(), [Edge(node=x_id, index=0), Edge(node=n_rqp, index=0)])
        s_res = sc[f"b{i}.res1"] / Q.MAX
        return _requant(m, n_add, s_x, s_res, Q.BIT_LEN + 2), s_res

    def _ffn(self, m: Model, x_id: int, s_x: float, blk: GPT2Block, i: int, sc: dict) -> tuple[int, float]:
        """Append block i's feed-forward half to `m` after node x_id (scale
        s_x), x_id feeding both the LayerNorm and the residual Add; returns
        (the last node, its scale)."""
        c = self.c
        ln = LayerNorm.from_float(blk.ln2_g, blk.ln2_b, c.eps, s_x, device=self.device)
        n_ln = m.add_node(ln, [Edge(node=x_id, index=0)])
        s_h = sc[f"b{i}.ln2"] / Q.MAX
        n_h = _requant(m, n_ln, _ln_out_scale(blk.ln2_g, s_x), s_h, ln.output_bitsize())

        s_w = _mx(blk.up_w) / Q.MAX
        mmu = MatMul.new_constant(self._tensor(_q(blk.up_w, s_w)), self._tensor(_q(blk.up_b, s_h * s_w)))
        n_mm = m.add_node(mmu, [Edge(node=n_h, index=0)])
        s_up = sc[f"b{i}.up"] / Q.MAX
        n_rq = _requant(m, n_mm, s_h * s_w, s_up, mmu.output_bitsize())
        s_gelu = sc[f"b{i}.gelu"] / Q.MAX
        n_g = m.add_node(Gelu(s_in=s_up, s_out=s_gelu), [Edge(node=n_rq, index=0)])
        s_w2 = _mx(blk.down_w) / Q.MAX
        mmd = MatMul.new_constant(self._tensor(_q(blk.down_w, s_w2)), self._tensor(_q(blk.down_b, s_gelu * s_w2)))
        n_mm2 = m.add_node(mmd, [Edge(node=n_g, index=0)])
        n_rqd = _requant(m, n_mm2, s_gelu * s_w2, s_x, mmd.output_bitsize())
        n_add = m.add_node(Add(), [Edge(node=x_id, index=0), Edge(node=n_rqd, index=0)])
        s_res = sc[f"b{i}.res2"] / Q.MAX
        return _requant(m, n_add, s_x, s_res, Q.BIT_LEN + 2), s_res


@dataclasses.dataclass
class GenerationStep:
    token: int
    trace: object
    proof: object = None


class Driver:
    """The token loop: one full-context inference (and, asked, its proof) a
    token, the argmax read at the last active position. Runs on the
    builder's device (`meta["device"]`)."""

    def __init__(self, model: Model, meta: dict, ctx=None):
        self.model = model
        self.meta = meta
        self.ctx = ctx

    def step(self, tokens: np.ndarray, prove: bool = False) -> GenerationStep:
        from ..transcript import BasicTranscript
        from .iop import Prover

        seq, dev = self.meta["seq"], self.meta["device"]
        toks = np.zeros(seq, dtype=np.int64)
        n_active = min(len(tokens), seq)
        toks[:n_active] = np.asarray(tokens, dtype=np.int64)[-seq:][:n_active]
        trace = self.model.run([Tensor(torch.from_numpy(toks).to(dev))], device=dev)
        token = int(trace.outputs[0].data.reshape(-1)[n_active - 1])
        proof = None
        if prove:
            assert self.ctx is not None, "proving requires a Context"
            proof = Prover(self.ctx, BasicTranscript(b"m2vec"), device=dev).prove(trace)
        return GenerationStep(token=token, trace=trace, proof=proof)

    def generate(self, prompt: list[int], n_tokens: int, prove: bool = False):
        tokens, steps = list(prompt), []
        for _ in range(n_tokens):
            st = self.step(np.asarray(tokens, dtype=np.int64), prove=prove)
            tokens.append(st.token)
            steps.append(st)
        return tokens, steps
