"""CLIP text encoder (ViT-L/14 text tower) in PyTorch — the port of
cremage_tpu/models/clip.py.

Module names follow the HF `text_model.*` keys
(`cond_stage_model.transformer.text_model.*` inside SD checkpoints).
Behaviors kept from the JAX module:
- forward from pre-computed input embeddings (the prompt-weighting
  pipeline scales token embeddings per word before the transformer);
  position embeddings are added in the compute dtype;
- all hidden states are returned so clip_skip can tap the raw hidden state
  13 - clip_skip (no final LayerNorm);
- the causal mask goes through the masked reference attention, not the
  flash kernel.
"""
from __future__ import annotations

import dataclasses
from typing import List

import torch
from torch import nn

from cremage_tpu_torch.models.layers import LayerNorm, Linear, quick_gelu
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    intermediate_size: int = 3072
    dtype: torch.dtype = torch.bfloat16


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        c = cfg.hidden_size
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
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = LayerNorm(cfg.hidden_size)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = LayerNorm(cfg.hidden_size)
        self.mlp = _MLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions,
                                               cfg.hidden_size)
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        nn.init.normal_(self.position_embedding.weight, std=0.02)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(CLIPLayer(cfg) for _ in range(cfg.num_layers))


class CLIPTextModel(nn.Module):
    """forward(inputs_embeds) -> (last_hidden_state, all_hidden_states).

    hidden_states[0] is the embedding output, hidden_states[i] the output
    of layer i (13 entries for ViT-L)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = LayerNorm(cfg.hidden_size)

    def embed_tokens(self, token_ids: torch.Tensor) -> torch.Tensor:
        """Raw float32 token-embedding lookup (pre-position)."""
        return self.embeddings.token_embedding.weight[token_ids]

    def forward(self, inputs_embeds: torch.Tensor):
        cfg = self.cfg
        n = inputs_embeds.shape[1]
        pos = self.embeddings.position_embedding.weight[:n]
        x = inputs_embeds.to(cfg.dtype) + pos.to(cfg.dtype)
        causal = torch.tril(torch.ones((n, n), dtype=torch.bool,
                                       device=x.device))[None, None]
        hidden_states: List[torch.Tensor] = [x]
        for layer in self.encoder.layers:
            x = layer(x, causal)
            hidden_states.append(x)
        return self.final_layer_norm(x), hidden_states


def hidden_state_for_clip_skip(hidden_states: List[torch.Tensor],
                               clip_skip: int) -> torch.Tensor:
    """clip_skip=1 -> hidden_states[12]: the raw hidden state, no final LN
    (reference encoders/modules.py:314)."""
    return hidden_states[len(hidden_states) - clip_skip]
