"""OpenCLIP text tower (ViT-bigG-14), SDXL's second text encoder, in
PyTorch — the port of cremage_tpu/models/open_clip.py.

Architecture contract (sgm `FrozenOpenCLIPEmbedder2`): width 1280, 32
layers, 20 heads, mlp ratio 4, exact gelu, pre-LN transformer, causal
mask, ln_final, text_projection. The "penultimate" hidden state feeds
crossattn; the pooled output is ln_final(last)[eos] @ text_projection.

Module names follow the checkpoint keys under
`conditioner.embedders.1.model.` with the fused attention input projection
split into q/k/v (io/checkpoint.py `openclip_text_subdict` splits it, as
the JAX loader does): token_embedding, positional_embedding (a bare
parameter), transformer.resblocks.{i}.{ln_1, attn.q_proj/k_proj/v_proj/
out_proj, ln_2, mlp.c_fc, mlp.c_proj}, ln_final, text_projection (a bare
(width, width) parameter used as x @ P). The causal mask goes through the
masked reference attention, not the flash kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import LayerNorm, Linear
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class OpenCLIPTextConfig:
    vocab_size: int = 49408
    width: int = 1280
    num_layers: int = 32
    num_heads: int = 20
    max_positions: int = 77
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16


def openclip_bigg_config(**kw) -> OpenCLIPTextConfig:
    return OpenCLIPTextConfig(**kw)


class _Attention(nn.Module):
    def __init__(self, cfg: OpenCLIPTextConfig):
        super().__init__()
        c = cfg.width
        self.heads = cfg.num_heads
        self.q_proj = Linear(c, c)
        self.k_proj = Linear(c, c)
        self.v_proj = Linear(c, c)
        self.out_proj = Linear(c, c)

    def forward(self, x, mask):
        b, n, c = x.shape
        h, d = self.heads, c // self.heads
        q = self.q_proj(x).view(b, n, h, d)
        k = self.k_proj(x).view(b, n, h, d)
        v = self.v_proj(x).view(b, n, h, d)
        return self.out_proj(attention(q, k, v, mask=mask).reshape(b, n, c))


class _MLP(nn.Module):
    def __init__(self, cfg: OpenCLIPTextConfig):
        super().__init__()
        self.c_fc = Linear(cfg.width, cfg.width * cfg.mlp_ratio)
        self.c_proj = Linear(cfg.width * cfg.mlp_ratio, cfg.width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResBlock(nn.Module):
    def __init__(self, cfg: OpenCLIPTextConfig):
        super().__init__()
        self.ln_1 = LayerNorm(cfg.width)
        self.attn = _Attention(cfg)
        self.ln_2 = LayerNorm(cfg.width)
        self.mlp = _MLP(cfg)

    def forward(self, x, mask):
        x = x + self.attn(self.ln_1(x), mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, cfg: OpenCLIPTextConfig):
        super().__init__()
        self.resblocks = nn.ModuleList(ResBlock(cfg)
                                       for _ in range(cfg.num_layers))


class OpenCLIPTextModel(nn.Module):
    """forward(inputs_embeds) -> (hidden_states, ln_final output).

    hidden_states[i] is the output of resblock i - 1 (index 0: the
    embeddings); the "penultimate" state is hidden_states[num_layers - 1]."""

    def __init__(self, cfg: OpenCLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(
            torch.randn(cfg.max_positions, cfg.width) * 0.01)
        self.transformer = _Transformer(cfg)
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = nn.Parameter(
            torch.randn(cfg.width, cfg.width) * 0.02)
        nn.init.normal_(self.token_embedding.weight, std=0.02)

    def embed_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Raw float32 token-embedding lookup (pre-position)."""
        return self.token_embedding.weight[token_ids]

    def forward(self, inputs_embeds: torch.Tensor):
        cfg = self.cfg
        n = inputs_embeds.shape[1]
        x = inputs_embeds.to(cfg.dtype) + \
            self.positional_embedding[:n].to(cfg.dtype)
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                       device=x.device))[None, None]
        hidden: List[torch.Tensor] = [x]
        for block in self.transformer.resblocks:
            x = block(x, causal)
            hidden.append(x)
        return hidden, self.ln_final(x)

    def project_pooled(self, final_ln: torch.Tensor,
                       eos_index: torch.Tensor) -> torch.Tensor:
        """ln_final(last)[eos] @ text_projection per batch row: the
        operands rounded to the compute dtype, the product accumulated and
        returned in float32, as the JAX module's preferred_element_type."""
        rows = torch.arange(final_ln.shape[0], device=final_ln.device)
        pooled = final_ln[rows, eos_index.to(final_ln.device).long()]
        dt = self.cfg.dtype
        return pooled.to(dt).float() @ self.text_projection.to(dt).float()
