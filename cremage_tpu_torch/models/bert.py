"""BERT encoder in PyTorch — the port of cremage_tpu/models/bert.py, as
Hunyuan-DiT's first text branch (diffusers HunyuanDiTPipeline's
`text_encoder`, a Chinese-CLIP BertModel, whose last hidden state
conditions the DiT).

Post-LN blocks (the original BERT residual order), LayerNorm eps 1e-12,
exact GELU, token types all zero. The attention mask goes through
ops/attention.py `dot_product_attention` with the mask (the plain masked
path, as CLIP's causal mask does): a mask skips the kernel, as it skips
Pallas in JAX.

Module names follow HF's BertModel keys (the checkpoint's, a `bert.` prefix
stripped by the loader): embeddings.{word,position,token_type}_embeddings,
embeddings.LayerNorm, encoder.layer.{i}.attention.self.{query,key,value},
encoder.layer.{i}.attention.output.{dense,LayerNorm},
encoder.layer.{i}.intermediate.dense, encoder.layer.{i}.output.{dense,
LayerNorm}, pooler.dense. The JAX module's safety-classifier head is not
ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import LayerNorm, Linear
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_positions: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    dtype: torch.dtype = torch.float32


def hunyuan_clip_config(**kw) -> BertConfig:
    """Hunyuan-DiT's text_encoder: the Chinese-CLIP BertModel, width 1024."""
    return BertConfig(vocab_size=47020, hidden_size=1024, num_layers=24,
                      num_heads=16, intermediate_size=4096, **kw)


class Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_positions,
                                                cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size,
                                                  cfg.hidden_size)
        self.LayerNorm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class Dense(nn.Module):
    """`dense` and, where BERT has one, the post-residual `LayerNorm`."""

    def __init__(self, n_in: int, n_out: int, eps: Optional[float] = None):
        super().__init__()
        self.dense = Linear(n_in, n_out)
        if eps is not None:
            self.LayerNorm = LayerNorm(n_out, eps=eps)


class SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.query = Linear(hidden, hidden)
        self.key = Linear(hidden, hidden)
        self.value = Linear(hidden, hidden)


class Attention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = SelfAttention(cfg.hidden_size)
        self.output = Dense(cfg.hidden_size, cfg.hidden_size,
                            cfg.layer_norm_eps)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.attention = Attention(cfg)
        self.intermediate = Dense(h, cfg.intermediate_size)
        self.output = Dense(cfg.intermediate_size, h, cfg.layer_norm_eps)

    def forward(self, x, mask):
        b, n, c = x.shape
        heads = self.cfg.num_heads
        sa = self.attention.self
        q, k, v = (p(x).view(b, n, heads, c // heads)
                   for p in (sa.query, sa.key, sa.value))
        a = attention(q, k, v, mask=mask).reshape(b, n, c)
        out = self.attention.output
        x = out.LayerNorm(x + out.dense(a))
        h = F.gelu(self.intermediate.dense(x))
        return self.output.LayerNorm(x + self.output.dense(h))


class Encoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(BertLayer(cfg) for _ in range(cfg.num_layers))


class BertModel(nn.Module):
    """forward(input_ids (B, N), attention_mask (B, N) or None) ->
    (last hidden state (B, N, hidden), pooled tanh(W · CLS)) in the compute
    dtype."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = Embeddings(cfg)
        self.encoder = Encoder(cfg)
        self.pooler = Dense(cfg.hidden_size, cfg.hidden_size)

    def forward(self, input_ids: torch.Tensor,
                attention_mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        emb = self.embeddings
        n = input_ids.shape[1]
        x = (emb.word_embeddings.weight[input_ids]
             + emb.position_embeddings.weight[:n][None]
             + emb.token_type_embeddings.weight[0]).to(self.cfg.dtype)
        x = emb.LayerNorm(x)
        mask = (None if attention_mask is None
                else attention_mask[:, None, None, :].bool())
        for blk in self.encoder.layer:
            x = blk(x, mask)
        return x, torch.tanh(self.pooler.dense(x[:, 0]))
