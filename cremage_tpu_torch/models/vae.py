"""KL autoencoder (SD first stage) in PyTorch, NCHW — the port of
cremage_tpu/models/vae.py.

Architecture contract: CompVis AutoencoderKL (v1-inference.yaml
first_stage_config: ch=128, ch_mult=(1,2,4,4), num_res_blocks=2, z=4, no
attention except mid). Module names follow the `first_stage_model.*`
checkpoint keys (`encoder.down.0.downsample.conv.weight`,
`decoder.up.3.block.0.norm1.weight`, `quant_conv`, `post_quant_conv`).
The JAX package folds nearest-2x + 3x3 conv into one 2x2-phase conv; here
it is the plain nearest upsample followed by the same 3x3 conv. Every
GroupNorm is kernel K2 on CUDA, each mid-block attention kernel K1.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import Conv2d, GroupNorm
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    ch: int = 128
    ch_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    z_channels: int = 4
    in_channels: int = 3
    out_ch: int = 3
    scale_factor: float = 0.18215
    shift_factor: float = 0.0
    dtype: torch.dtype = torch.bfloat16


def sdxl_vae_config(**kw) -> VAEConfig:
    """SDXL's VAE: SD1.5's architecture with scale factor 0.13025."""
    return VAEConfig(scale_factor=0.13025, **kw)


class ResnetBlock(nn.Module):
    def __init__(self, ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(ch, 32, eps=1e-6, fuse_silu=True)
        self.conv1 = Conv2d(ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch, 32, eps=1e-6, fuse_silu=True)
        self.conv2 = Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = Conv2d(ch, out_ch, 1) if ch != out_ch else None

    def forward(self, x):
        h = self.conv2(self.norm2(self.conv1(self.norm1(x))))
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock(nn.Module):
    """Single-head full self-attention over spatial tokens (mid block)."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = GroupNorm(ch, 32, eps=1e-6)
        self.q = Conv2d(ch, ch, 1)
        self.k = Conv2d(ch, ch, 1)
        self.v = Conv2d(ch, ch, 1)
        self.proj_out = Conv2d(ch, ch, 1)

    def forward(self, x):
        b, c, hh, ww = x.shape
        h = self.norm(x)

        def tokens(t):  # (B, C, H, W) -> contiguous (B, HW, 1, C)
            return t.permute(0, 2, 3, 1).reshape(b, hh * ww, 1, c).contiguous()

        o = attention(tokens(self.q(h)), tokens(self.k(h)), tokens(self.v(h)))
        o = o.reshape(b, hh, ww, c).permute(0, 3, 1, 2).contiguous()
        return x + self.proj_out(o)


class DownsampleVAE(nn.Module):
    """Pad (0, 1, 0, 1), then a 3x3 stride-2 conv without padding: the
    asymmetric padding of the torch checkpoints, which nn.Conv2d's own
    padding cannot express."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock(ch, ch)
        self.attn_1 = AttnBlock(ch)
        self.block_2 = ResnetBlock(ch, ch)


class _Down(nn.Module):
    def __init__(self, blocks, downsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if downsample is not None:
            self.downsample = downsample


class _Up(nn.Module):
    def __init__(self, blocks, upsample):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if upsample is not None:
            self.upsample = upsample


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.ch
        self.conv_in = Conv2d(cfg.in_channels, ch, 3, padding=1)
        down = []
        for level, mult in enumerate(cfg.ch_mult):
            blocks = []
            for _ in range(cfg.num_res_blocks):
                blocks.append(ResnetBlock(ch, cfg.ch * mult))
                ch = cfg.ch * mult
            last = level == len(cfg.ch_mult) - 1
            down.append(_Down(blocks, None if last else DownsampleVAE(ch)))
        self.down = nn.ModuleList(down)
        self.mid = _Mid(ch)
        self.norm_out = GroupNorm(ch, 32, eps=1e-6, fuse_silu=True)
        self.conv_out = Conv2d(ch, 2 * cfg.z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.to(self.cfg.dtype))
        for level in self.down:
            for blk in level.block:
                h = blk(h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(self.norm_out(h))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        ch = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = Conv2d(cfg.z_channels, ch, 3, padding=1)
        self.mid = _Mid(ch)
        up = []
        for level in reversed(range(len(cfg.ch_mult))):
            out_ch = cfg.ch * cfg.ch_mult[level]
            blocks = []
            for _ in range(cfg.num_res_blocks + 1):
                blocks.append(ResnetBlock(ch, out_ch))
                ch = out_ch
            up.insert(0, _Up(blocks, Upsample(ch) if level != 0 else None))
        self.up = nn.ModuleList(up)
        self.norm_out = GroupNorm(ch, 32, eps=1e-6, fuse_silu=True)
        self.conv_out = Conv2d(ch, cfg.out_ch, 3, padding=1)

    def forward(self, z):
        h = self.conv_in(z.to(self.cfg.dtype))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(range(len(self.up))):
            for blk in self.up[level].block:
                h = blk(h)
            if level != 0:
                h = self.up[level].upsample(h)
        return self.conv_out(self.norm_out(h))


class AutoencoderKL(nn.Module):
    """encode(x NCHW) -> (mean, logvar) of the posterior; decode(z NCHW)."""

    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.decoder = Decoder(cfg)
        self.quant_conv = Conv2d(2 * cfg.z_channels, 2 * cfg.z_channels, 1)
        self.post_quant_conv = Conv2d(cfg.z_channels, cfg.z_channels, 1)

    def encode(self, x):
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z.to(self.cfg.dtype)))


def encode_to_latent(vae: AutoencoderKL, x: torch.Tensor,
                     posterior_noise: Optional[Callable] = None
                     ) -> torch.Tensor:
    """Image (B, H, W, 3) in [-1, 1] -> scaled latent (B, h, w, C) in the
    model dtype: z = (mean - shift) * scale, or, given `posterior_noise`
    (shape -> standard-normal float32 noise of that NHWC shape), the
    posterior sample mean + exp(0.5 logvar) * noise, with the noise cast
    to the model dtype first, as the JAX package draws it."""
    mean, logvar = vae.encode(x.permute(0, 3, 1, 2).contiguous())
    z = mean
    if posterior_noise is not None:
        b, c, h, w = mean.shape
        eps = posterior_noise((b, h, w, c)).permute(0, 3, 1, 2).to(mean.dtype)
        z = mean + torch.exp(0.5 * logvar) * eps
    z = (z - vae.cfg.shift_factor) * vae.cfg.scale_factor
    return z.permute(0, 2, 3, 1)


def decode_from_latent(vae: AutoencoderKL, z: torch.Tensor) -> torch.Tensor:
    """Scaled latent (B, h, w, C) -> image (B, H, W, 3) in [-1, 1]: divide
    by the scale factor and add the shift in z's dtype, as the reference's
    decode_first_stage does."""
    z = z / vae.cfg.scale_factor + vae.cfg.shift_factor
    return vae.decode(z.permute(0, 3, 1, 2).contiguous()).permute(0, 2, 3, 1)
