"""T5 v1.1 encoder in PyTorch — the port of cremage_tpu/models/t5.py (the
text tower of FLUX, and as mT5-XL Hunyuan-DiT's second text branch).

Relative-position-bucket attention bias (one table, shared by every
layer), RMSNorm, gated tanh-GELU feed-forward, no biases. T5 does not
scale the logits by 1/sqrt(d), and its bias is added to them, so the
attention is plain float32 einsums here, as in JAX (not the flash
kernel).

Module names follow the HF encoder keys with `encoder.` stripped and the
block-0 bias table lifted to `relative_attention_bias` (the renames of
cremage_tpu/pipelines/loader.py `load_flux_bundle`): shared.weight,
relative_attention_bias.weight, block.{i}.layer.0.SelfAttention.{q,k,v,o},
block.{i}.layer.0.layer_norm, block.{i}.layer.1.DenseReluDense.{wi_0,
wi_1,wo}, block.{i}.layer.1.layer_norm, final_layer_norm.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import Linear


@dataclasses.dataclass(frozen=True)
class T5Config:
    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    num_heads: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: torch.dtype = torch.bfloat16


def t5_xxl_config(**kw) -> T5Config:
    return T5Config(**kw)


def mt5_xl_config(**kw) -> T5Config:
    """Hunyuan-DiT's text_encoder_2: the mT5-XL encoder (multilingual
    vocabulary, the same gated-GELU v1.1 blocks)."""
    return T5Config(vocab_size=250112, d_model=2048, num_heads=32, d_ff=5120,
                    num_layers=24, **kw)


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        var = (x32 * x32).mean(-1, keepdim=True)
        return (x32 / torch.sqrt(var + self.eps) * self.weight).to(x.dtype)


def relative_position_bucket(relative_position, num_buckets=32,
                             max_distance=128) -> np.ndarray:
    """T5's bidirectional relative-position buckets (host numpy)."""
    rp = np.asarray(relative_position)
    num_buckets //= 2
    ret = (rp > 0).astype(np.int64) * num_buckets
    n = np.abs(rp)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_large = max_exact + (
        np.log(np.maximum(n, 1) / max_exact)
        / np.log(max_distance / max_exact)
        * (num_buckets - max_exact)).astype(np.int64)
    val_large = np.minimum(val_large, num_buckets - 1)
    return ret + np.where(is_small, n, val_large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = Linear(cfg.d_model, inner, bias=False)
        self.k = Linear(cfg.d_model, inner, bias=False)
        self.v = Linear(cfg.d_model, inner, bias=False)
        self.o = Linear(inner, cfg.d_model, bias=False)

    def forward(self, x, position_bias):
        cfg = self.cfg
        b, n, _ = x.shape
        shape = (b, n, cfg.num_heads, cfg.d_kv)
        q, k, v = (p(x).view(shape) for p in (self.q, self.k, self.v))
        logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(logits + position_bias, dim=-1).to(v.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float())
        return self.o(out.to(x.dtype).reshape(b, n, -1))


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.SelfAttention = T5Attention(cfg)


class _GatedFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, h):
        return self.wo(F.gelu(self.wi_0(h), approximate="tanh") * self.wi_1(h))


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)
        self.DenseReluDense = _GatedFF(cfg)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg), _FFLayer(cfg)])

    def forward(self, x, position_bias):
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), position_bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class T5Encoder(nn.Module):
    """forward(input_ids (B, N), attention_mask (B, N) or None) -> the
    final RMS-normed hidden states (B, N, d_model), compute dtype. The
    `shared` table and the bias table stay float32."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.relative_attention_bias = nn.Embedding(
            cfg.relative_attention_num_buckets, cfg.num_heads)
        self.block = nn.ModuleList(T5Block(cfg) for _ in range(cfg.num_layers))
        self.final_layer_norm = RMSNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        x = self.shared.weight[input_ids].to(cfg.dtype)
        n = x.shape[1]
        pos = np.arange(n)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets,
            cfg.relative_attention_max_distance)
        table = self.relative_attention_bias.weight.float()
        bias = table[torch.from_numpy(buckets).to(x.device)].permute(2, 0, 1)[None]
        if attention_mask is not None:
            bias = bias + (1.0 - attention_mask[:, None, None, :].float()) * -1e9
        for blk in self.block:
            x = blk(x, bias)
        return self.final_layer_norm(x)
