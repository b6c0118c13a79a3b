"""Shared PyTorch building blocks for the diffusion model graphs (the
port's counterpart of cremage_tpu/models/layers.py).

Conventions:
- activations are NCHW, conv weights OIHW and linear weights (out, in), as
  in the torch checkpoints, so module names and shapes follow the
  checkpoint keys directly;
- Conv2d and Linear keep their weights in the compute dtype (see
  `set_compute_dtype`) and run like the JAX layers: accumulate in fp32,
  round to the compute dtype, then add the bias in the compute dtype;
- GroupNorm/LayerNorm parameters and statistics stay float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.ops.groupnorm import group_norm_silu


def timestep_embedding(t: torch.Tensor, dim: int,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding, CompVis convention: half-dim
    exp-decayed freqs, [cos, sin] order, float32."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


class GroupNorm(nn.Module):
    """GroupNorm with fp32 statistics and parameters; `fuse_silu` fuses the
    following SiLU into the same pass (kernel K2 on CUDA)."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = 1e-5,
                 fuse_silu: bool = False):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.fuse_silu = fuse_silu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return group_norm_silu(x, self.weight, self.bias, groups=self.num_groups,
                               eps=self.eps, silu=self.fuse_silu)


class Conv2d(nn.Conv2d):
    def forward(self, x):
        y = F.conv2d(x, self.weight.to(x.dtype), None, self.stride,
                     self.padding)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)[:, None, None]
        return y


class Linear(nn.Linear):
    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics, returning the input dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def quick_gelu(x):
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every Conv2d/Linear weight and bias in `dtype` (the compute
    dtype); norm parameters and embedding tables stay float32."""
    for m in module.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.to(dtype)
    return module
