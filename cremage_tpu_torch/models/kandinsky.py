"""Kandinsky 2.2's prior transformer and image conditioner in PyTorch — the
port of cremage_tpu/models/kandinsky.py.

Architecture contract (diffusers' PriorTransformer and the decoder UNet's
image heads, as the JAX modules give them):
- `DiffusionPrior`: the token stream [text tokens (77), pooled text,
  time, noisy image embedding, learned query] plus a learned position
  table, pre-LN transformer blocks with exact GELU under a causal mask
  (which takes the plain masked attention path, as JAX's masked call goes
  to XLA), a final LayerNorm, the output read at the last position;
- `KandinskyImageConditioner`: the decoder's time vector (Linear +
  LayerNorm, added to the UNet's time embedding) and its 10 context tokens
  (Linear, reshape, LayerNorm) from the image embedding.

Module names follow the JAX parameter names with dots for underscores
(io/diffusers_keys.py `kandinsky_prior_from_diffusers` and
`kandinsky_image_conditioner_from_diffusers` map the diffusers keys to
them). Linear layers run in the compute dtype, LayerNorms in float32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import LayerNorm, Linear, timestep_embedding
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    image_embed_dim: int = 1280
    text_embed_dim: int = 1280
    hidden: int = 2048
    num_layers: int = 20
    num_heads: int = 32
    text_tokens: int = 77
    dtype: torch.dtype = torch.bfloat16


class PriorBlock(nn.Module):
    def __init__(self, cfg: PriorConfig):
        super().__init__()
        c = cfg.hidden
        self.heads = cfg.num_heads
        self.ln_1 = LayerNorm(c)
        self.q_proj = Linear(c, c)
        self.k_proj = Linear(c, c)
        self.v_proj = Linear(c, c)
        self.out_proj = Linear(c, c)
        self.ln_2 = LayerNorm(c)
        self.mlp_fc = Linear(c, 4 * c)
        self.mlp_proj = Linear(4 * c, c)

    def forward(self, x, mask):
        b, n, c = x.shape
        h, d = self.heads, c // self.heads
        y = self.ln_1(x)
        q = self.q_proj(y).view(b, n, h, d)
        k = self.k_proj(y).view(b, n, h, d)
        v = self.v_proj(y).view(b, n, h, d)
        x = x + self.out_proj(attention(q, k, v, mask=mask).reshape(b, n, c))
        return x + self.mlp_proj(F.gelu(self.mlp_fc(self.ln_2(x))))


class _TimeEmbedding(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.linear_1 = Linear(c, c)
        self.linear_2 = Linear(c, c)


class DiffusionPrior(nn.Module):
    """forward(noisy image embedding (B, E), t (B,), text tokens (B, L,
    T), pooled text (B, T)) -> the predicted eps (B, E) in the compute
    dtype."""

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        self.cfg = cfg
        c = cfg.hidden
        self.text_proj = Linear(cfg.text_embed_dim, c)
        self.pooled_proj = Linear(cfg.text_embed_dim, c)
        self.time_embedding = _TimeEmbedding(c)
        self.image_embed_proj = Linear(cfg.image_embed_dim, c)
        self.prd_embedding = nn.Parameter(torch.randn(1, 1, c) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(cfg.text_tokens + 4, c) * 0.01)
        self.blocks = nn.ModuleList(PriorBlock(cfg)
                                    for _ in range(cfg.num_layers))
        self.final_ln = LayerNorm(c)
        self.out_proj = Linear(c, cfg.image_embed_dim)

    def forward(self, noisy_image_embed, t, text_tokens, text_pooled):
        cfg = self.cfg
        dt, c = cfg.dtype, cfg.hidden
        b = noisy_image_embed.shape[0]
        txt = self.text_proj(text_tokens.to(dt))
        pool = self.pooled_proj(text_pooled.to(dt))[:, None]
        te = self.time_embedding
        temb = te.linear_1(timestep_embedding(t, c).to(dt))
        temb = te.linear_2(F.silu(temb))[:, None]
        img = self.image_embed_proj(noisy_image_embed.to(dt))[:, None]
        query = self.prd_embedding.to(dt).expand(b, 1, c)
        x = torch.cat([txt, pool, temb, img, query], dim=1)
        n = x.shape[1]
        x = x + self.positional_embedding[:n].to(dt)
        mask = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                     device=x.device))[None, None]
        for block in self.blocks:
            x = block(x, mask)
        return self.out_proj(self.final_ln(x)[:, -1])


class KandinskyImageConditioner(nn.Module):
    """forward(image embedding (B, E)) -> (time vector (B, time_embed_dim),
    context tokens (B, num_tokens, cross_dim)), in the compute dtype."""

    def __init__(self, image_embed_dim: int, time_embed_dim: int,
                 cross_dim: int, num_tokens: int = 10,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.num_tokens, self.cross_dim = num_tokens, cross_dim
        self.image_proj = Linear(image_embed_dim, time_embed_dim)
        self.image_norm = LayerNorm(time_embed_dim)
        self.context_proj = Linear(image_embed_dim, num_tokens * cross_dim)
        self.context_norm = LayerNorm(cross_dim)

    def forward(self, image_embed):
        x = image_embed.to(self.dtype)
        tvec = self.image_norm(self.image_proj(x))
        ctx = self.context_proj(x).reshape(x.shape[0], self.num_tokens,
                                           self.cross_dim)
        return tvec, self.context_norm(ctx)
