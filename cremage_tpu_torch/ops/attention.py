"""Attention ops: the masked reference and the dispatch to the kernel.

Shapes follow (B, N, H, D) — batch, tokens, heads, head_dim. Softmax is
always computed in float32 regardless of compute dtype.

- `dot_product_attention`: plain PyTorch attention with fp32 logits and
  softmax, an optional mask at -1e9 and probabilities cast to v's dtype
  before the PV product (semantics of cremage_tpu/ops/attention.py
  `dot_product_attention_xla`). CLIP's causal mask runs here.
- `attention`: every unmasked call goes to the flash-attention kernel
  (ops/flash_attention.py), which on a CUDA tensor launches the kernel
  and on a CPU tensor runs its plain version.
"""
from __future__ import annotations

from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Reference attention. q, k, v: (B, N, H, D); mask: optional bool
    (..., Nq, Nk), True = attend."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.tensor(-1e9, device=q.device))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: Optional[float] = None,
              mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Multi-head attention dispatch. q, k, v: (B, N, H, D)."""
    if mask is None:
        from cremage_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, scale=scale)
    return dot_product_attention(q, k, v, scale=scale, mask=mask)
