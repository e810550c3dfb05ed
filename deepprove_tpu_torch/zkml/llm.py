"""GPT-2: configuration, weights, float calibration and the provable
feed-forward half of a block, as in the JAX package's `zkml/llm.py`.

The host part is numpy, copied: the synthetic weights, the float forward
that calibrates every activation's scale, and the quantization helpers
(float64, round half to even). `GPT2Builder._ffn` appends one block's
feed-forward half to a Model on the builder's device: LayerNorm ->
Requant -> MatMul (up, with bias) -> Requant -> Gelu -> MatMul (down) ->
Requant -> Add (the residual) -> Requant. The attention half, the whole
graph (`build`), the generation loop (`Driver`) and the GGUF loader arrive
with the port's attention slice (ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import device as device_mod
from . import quantization as Q
from .layers.activation import Gelu
from .layers.add import Add
from .layers.layernorm import LayerNorm
from .layers.matmul import MatMul
from .layers.requant import Requant
from .lookup_context import LAYERNORM_OUTPUT_SCALE_FACTOR
from .model import Edge, Model
from .quantization import RequantSpec
from .tensor import next_pow2

_LATER = "arrives with the port's attention slice (ROADMAP queue 1 item 4)"


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
    spec = RequantSpec.from_multiplier(s_before / s_after, bits)
    return m.add_node(Requant(spec=spec), [Edge(node=src, index=0)])


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
        raise NotImplementedError(f"GPT2Builder.build {_LATER}")

    def _attention(self, m, x_id, s_x, blk, i, sc):
        raise NotImplementedError(f"GPT2Builder._attention {_LATER}")

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


class Driver:
    """The token loop: one full-context inference (and proof) a token."""

    def __init__(self, model: Model, meta: dict, ctx=None):
        raise NotImplementedError(f"Driver {_LATER}")
