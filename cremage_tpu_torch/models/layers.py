"""Shared PyTorch building blocks for the diffusion model graphs (the
port's counterpart of cremage_tpu/models/layers.py).

Conventions:
- activations are NCHW, conv weights OIHW and linear weights (out, in), as
  in the torch checkpoints, so module names and shapes follow the
  checkpoint keys directly;
- Conv2d and Linear keep their weights in the compute dtype (see
  `set_compute_dtype`) and run like the JAX layers: accumulate in fp32,
  round to the compute dtype, then add the bias in the compute dtype;
  `Linear8bit` holds 8-bit codes and a `weight_scale` instead
  (io/quantize.py), and `PatchConv8bit` the int8 codes of a DiT's patch
  embedding;
- GroupNorm/LayerNorm parameters and statistics stay float32.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.io.quantize import is_coded
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


class Conv2dF32(Conv2d):
    """A convolution the JAX package runs in float32 (its `Conv(...,
    dtype=jnp.float32)`, e.g. Kandinsky's output convolutions): input,
    weight and bias in float32, whatever the compute dtype; its weights
    stay float32 under `set_compute_dtype`."""

    def forward(self, x):
        y = F.conv2d(x.float(), self.weight.float(), None, self.stride,
                     self.padding)
        if self.bias is not None:
            y = y + self.bias.float()[:, None, None]
        return y


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., in) @ w (out, in)^T accumulated and returned in float32, both
    operands in x's dtype: on CUDA one cuBLAS product with a float32
    output, on the CPU a float32 product."""
    if x.device.type == "cuda":
        y = torch.mm(x.reshape(-1, x.shape[-1]), w.t(), out_dtype=torch.float32)
        return y.view(x.shape[:-1] + (w.shape[0],))
    return F.linear(x.float(), w.float())


def _int_mm(rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """rows (M, K) int8 @ w (N, K)^T int8 -> (M, N) int32. cuBLAS's int8
    product takes more than 16 rows and K and N multiples of 8
    (Hunyuan-DiT's MLP is 6054 wide): zero rows, columns and weight rows
    pad the operands, which leaves the int32 sums exact, and are cut off."""
    (m, k), n = rows.shape, w.shape[0]
    pad_k, pad_n = -k % 8, -n % 8
    rows = F.pad(rows, (0, pad_k, 0, max(0, 17 - m)))
    if pad_k or pad_n:
        w = F.pad(w, (0, pad_k, 0, pad_n))
    return torch._int_mm(rows, w.t())[:m, :n]


def _w8a8(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 product with the activations quantized per
    token at use (cremage_tpu/models/layers.py `_dynamic_int8`): scale =
    max(max|x| over the row / 127, 1e-12), codes round(x / scale). ->
    the int32 product times the row scales, float32."""
    a_scale = torch.clamp_min(x.abs().amax(-1, keepdim=True).float() / 127.0,
                              1e-12)
    xq = torch.round(x.float() / a_scale).to(torch.int8)
    acc = _int_mm(xq.reshape(-1, x.shape[-1]), w)
    return acc.float().view(x.shape[:-1] + (w.shape[0],)) * a_scale


class Linear(nn.Linear):
    def forward(self, x):
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class Linear8bit(Linear):
    """A Linear over 8-bit weight storage: codes as its weight and a
    float32 `weight_scale` per output row (io/quantize.py `set_8bit` makes
    a Linear one), in the order of cremage_tpu/models/layers.py `Dense`:
    float8 codes are cast to the compute dtype, the product accumulates in
    float32, then the output column scale, then the cast, then the bias;
    int8 codes take the w8a8 product (`_w8a8`), then the column scale."""

    def forward(self, x):
        w = self.weight
        if w.dtype == torch.int8:
            y = _w8a8(x, w)
        else:
            y = _mm_f32(x, w.to(x.dtype))
        y = (y * self.weight_scale).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class PatchConv8bit(Conv2d):
    """A patch embedding (stride = kernel, no padding) over int8 codes and
    a float32 `weight_scale` per output channel (io/quantize.py `set_8bit`
    makes a Conv2d one), in the order of cremage_tpu/models/layers.py
    `Conv`'s w8a8 branch: the activations quantized per image (scale =
    max(max|x| over the image / 127, 1e-12), codes round(x / scale)), the
    int8 x int8 -> int32 product, then the image scale, the channel scale,
    the cast and the bias. The patches do not overlap, so JAX's int8
    convolution is exactly the product of each patch (c, dy, dx) with the
    weight rows: `torch._int_mm` over the patches."""

    def forward(self, x):
        w = self.weight
        o, c, p, _ = w.shape
        if self.stride != (p, p) or self.padding != (0, 0):
            raise NotImplementedError("int8 convolution other than a patch "
                                      "embedding (stride = kernel, no padding)")
        b, _, h, wd = x.shape
        a_scale = torch.clamp_min(
            x.abs().amax(dim=(1, 2, 3)).float() / 127.0, 1e-12)
        xq = torch.round(x.float() / a_scale[:, None, None, None]).to(torch.int8)
        hp, wp = h // p, wd // p
        rows = xq.reshape(b, c, hp, p, wp, p).permute(0, 2, 4, 1, 3, 5)
        acc = _int_mm(rows.reshape(b * hp * wp, c * p * p), w.reshape(o, -1))
        y = acc.float().view(b, hp * wp, o) * a_scale[:, None, None]
        y = (y * self.weight_scale).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y.transpose(1, 2).reshape(b, o, hp, wp)


class LayerNorm(nn.LayerNorm):
    """LayerNorm with fp32 statistics, returning the input dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


def quick_gelu(x):
    """OpenAI CLIP activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


def set_compute_dtype(module: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Store every Conv2d/Conv3d/Linear weight and bias in `dtype` (the
    compute dtype); norm parameters, embedding tables, the video UNet's
    blend factors and `Conv2dF32`'s weights stay float32, and 8-bit
    weights (io/quantize.py) and their scales as they are."""
    for m in module.modules():
        if isinstance(m, (Conv2d, nn.Conv3d, Linear)) \
                and not isinstance(m, Conv2dF32):
            for p in m.parameters(recurse=False):
                if not is_coded(p):
                    p.data = p.data.to(dtype)
    return module
