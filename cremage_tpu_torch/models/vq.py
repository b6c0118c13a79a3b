"""Kandinsky 2.2's MoVQ decoder in PyTorch, NCHW — the port of the MoVQ half
of cremage_tpu/models/vq.py (Stable Cascade's Paella decoder is not ported
yet).

Architecture contract (diffusers' VQModel with norm_type "spatial", as the
JAX module gives it):
- `SpatialNorm`: GroupNorm of the features (kernel K2 without SiLU, eps
  1e-5 as JAX's; diffusers builds it with 1e-6), times conv_y of the
  quantized latent zq and plus conv_b of it, zq upsampled by nearest to the
  features' size;
- `MoVQResBlock`: SpatialNorm, SiLU, conv1, SpatialNorm, SiLU, conv2, a
  1x1 shortcut where the widths differ;
- `MoVQAttention`: the middle block's single-head attention over every
  latent pixel (kernel K1 at d = 512 over 9216 tokens at 768^2);
- `MoVQDecoder`: conv_in, the middle block, the up blocks (the deepest
  first, nearest 2x upsampling and a 3x3 conv after each but the last),
  SpatialNorm, SiLU and conv_out in float32;
- `MoVQ`: diffusers' VQModel.decode without the codebook lookup,
  decoder(post_quant_conv(z), zq=z) (`force_not_quantize`).

Module names follow the diffusers keys under `decoder.` (mid_block,
up_blocks.N.resnets.M.norm1.norm_layer, ...upsamplers.0.conv, conv_norm_out,
mid_block.attentions.0.to_out.0), which the JAX module's names flatten to.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import Conv2d, Conv2dF32, GroupNorm, Linear
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class MoVQConfig:
    latent_channels: int = 4
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 256, 512)
    layers_per_block: int = 2
    dtype: torch.dtype = torch.bfloat16


class SpatialNorm(nn.Module):
    def __init__(self, c: int, zq_channels: int):
        super().__init__()
        self.norm_layer = GroupNorm(c, 32)
        self.conv_y = Conv2d(zq_channels, c, 1)
        self.conv_b = Conv2d(zq_channels, c, 1)

    def forward(self, f, zq):
        scale = f.shape[2] // zq.shape[2]
        if scale != 1:
            zq = F.interpolate(zq, scale_factor=scale, mode="nearest")
        zq = zq.to(f.dtype)
        return self.norm_layer(f) * self.conv_y(zq) + self.conv_b(zq)


class MoVQResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, zq_channels: int):
        super().__init__()
        self.norm1 = SpatialNorm(cin, zq_channels)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.norm2 = SpatialNorm(cout, zq_channels)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, zq):
        h = self.conv1(F.silu(self.norm1(x, zq)))
        h = self.conv2(F.silu(self.norm2(h, zq)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class MoVQAttention(nn.Module):
    def __init__(self, c: int, zq_channels: int):
        super().__init__()
        self.spatial_norm = SpatialNorm(c, zq_channels)
        self.to_q = Linear(c, c)
        self.to_k = Linear(c, c)
        self.to_v = Linear(c, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x, zq):
        b, c, hh, ww = x.shape
        n = hh * ww
        t = self.spatial_norm(x, zq).permute(0, 2, 3, 1).reshape(b, n, c)
        a = attention(self.to_q(t).view(b, n, 1, c), self.to_k(t).view(b, n, 1, c),
                      self.to_v(t).view(b, n, 1, c))
        out = self.to_out[0](a.reshape(b, n, c))
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2).contiguous()


class _Mid(nn.Module):
    def __init__(self, c: int, z: int):
        super().__init__()
        self.resnets = nn.ModuleList([MoVQResBlock(c, c, z),
                                      MoVQResBlock(c, c, z)])
        self.attentions = nn.ModuleList([MoVQAttention(c, z)])


class _Up(nn.Module):
    def __init__(self, resnets, upsample_channels):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if upsample_channels:
            self.upsamplers = nn.ModuleList([_UpConv(upsample_channels)])


class _UpConv(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv = Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class MoVQDecoder(nn.Module):
    """forward(zq (B, z, h, w), x = the decoder input (zq when None))
    -> images (B, out, H, W) float32 in about [-1, 1]."""

    def __init__(self, cfg: MoVQConfig):
        super().__init__()
        self.cfg = cfg
        boc, z = cfg.block_out_channels, cfg.latent_channels
        self.conv_in = Conv2d(z, boc[-1], 3, padding=1)
        self.mid_block = _Mid(boc[-1], z)
        cur, up = boc[-1], []
        for lv in reversed(range(len(boc))):
            res = []
            for _ in range(cfg.layers_per_block + 1):
                res.append(MoVQResBlock(cur, boc[lv], z))
                cur = boc[lv]
            up.append(_Up(res, cur if lv != 0 else 0))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = SpatialNorm(boc[0], z)
        self.conv_out = Conv2dF32(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, zq, x=None):
        dt = self.cfg.dtype
        zq = zq.to(dt)
        h = self.conv_in((zq if x is None else x).to(dt))
        mid = self.mid_block
        h = mid.resnets[0](h, zq)
        h = mid.attentions[0](h, zq)
        h = mid.resnets[1](h, zq)
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h, zq)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(F.silu(self.conv_norm_out(h, zq)))


class MoVQ(nn.Module):
    """The decoding half of diffusers' VQModel: `decode(latents (B, h, w,
    z) NHWC)` -> images (B, H, W, 3) float32 in about [-1, 1]. The latent
    is rounded to the compute dtype, goes through post_quant_conv (a 1x1
    convolution) into the decoder and conditions every SpatialNorm as it
    is."""

    def __init__(self, cfg: MoVQConfig):
        super().__init__()
        self.cfg = cfg
        z = cfg.latent_channels
        self.decoder = MoVQDecoder(cfg)
        self.post_quant_conv = Conv2d(z, z, 1)

    def decode(self, lat):
        z = lat.permute(0, 3, 1, 2).to(self.cfg.dtype).contiguous()
        return self.decoder(z, self.post_quant_conv(z)).permute(0, 2, 3, 1)
