"""Stable Diffusion UNet (SD1.5, SDXL base and refiner) in PyTorch, NCHW,
bf16 compute / fp32 norms — the port of cremage_tpu/models/unet.py,
`mode="full"` only.

Architecture contract follows the CompVis/sgm `UNetModel`
(v1-inference.yaml, sd_xl_base.yaml, sd_xl_refiner.yaml). SDXL adds the
`label_emb` MLP over the vector conditioning `y` (added to the time
embedding), Linear proj_in/proj_out on tokens
(`use_linear_in_transformer`), per-level transformer depths and 64-wide
heads.
Module names follow the torch checkpoint keys under
`model.diffusion_model.`, e.g. `input_blocks.1.0.in_layers.0.weight`; the
Sequential slots that hold no parameters (SiLU, dropout) are Identity
placeholders so the indices match. Attention goes through ops/attention.py
(kernel K1 on CUDA), every GroupNorm through ops/groupnorm.py (kernel K2).
`forward(..., control=)` adds a ControlNet's residuals (models/controlnet.py)
to the skip connections and the middle block's output. IP-Adapter, ToMe and
DeepCache are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import (
    Conv2d, GroupNorm, LayerNorm, Linear, timestep_embedding,
)
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    model_channels: int = 320
    num_res_blocks: int = 2
    attention_resolutions: Tuple[int, ...] = (4, 2, 1)
    channel_mult: Tuple[int, ...] = (1, 2, 4, 4)
    num_heads: int = 8                 # used when num_head_channels == -1
    num_head_channels: int = -1
    transformer_depth: Tuple[int, ...] = (1, 1, 1, 1)  # per level
    transformer_depth_middle: int = 1
    context_dim: int = 768
    adm_in_channels: int = 0           # 0 = no vector conditioning
    use_linear_in_transformer: bool = False
    dtype: torch.dtype = torch.bfloat16


def sd15_unet_config(**kw) -> UNetConfig:
    """v1-inference.yaml unet_config."""
    return UNetConfig(**kw)


def sdxl_base_unet_config(**kw) -> UNetConfig:
    """sd_xl_base.yaml network_config."""
    return UNetConfig(
        in_channels=4, out_channels=4, model_channels=320,
        attention_resolutions=(4, 2), channel_mult=(1, 2, 4),
        num_head_channels=64, num_heads=-1, transformer_depth=(1, 2, 10),
        transformer_depth_middle=10, context_dim=2048, adm_in_channels=2816,
        use_linear_in_transformer=True, **kw)


def sdxl_refiner_unet_config(**kw) -> UNetConfig:
    """sd_xl_refiner.yaml network_config."""
    return UNetConfig(
        in_channels=4, out_channels=4, model_channels=384,
        attention_resolutions=(4, 2), channel_mult=(1, 2, 4, 4),
        num_head_channels=64, num_heads=-1, transformer_depth=(4, 4, 4, 4),
        transformer_depth_middle=4, context_dim=1280, adm_in_channels=2560,
        use_linear_in_transformer=True, **kw)


def _heads_for(ch: int, cfg: UNetConfig) -> Tuple[int, int]:
    if cfg.num_head_channels == -1:
        return cfg.num_heads, ch // cfg.num_heads
    return ch // cfg.num_head_channels, cfg.num_head_channels


class CrossAttention(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(context_dim, inner, bias=False)
        self.to_v = Linear(context_dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Identity())

    def forward(self, x, context=None):
        ctx = x if context is None else context
        b, n, _ = x.shape
        m = ctx.shape[1]
        q = self.to_q(x).view(b, n, self.heads, self.dim_head)
        k = self.to_k(ctx).view(b, m, self.heads, self.dim_head)
        v = self.to_v(ctx).view(b, m, self.heads, self.dim_head)
        out = attention(q, k, v).reshape(b, n, self.heads * self.dim_head)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        # tanh-gelu under bf16 compute, exact erf-gelu otherwise, as the JAX
        # UNet chooses
        approx = "tanh" if x.dtype == torch.bfloat16 else "none"
        return h * F.gelu(gate, approximate=approx)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.Sequential(GEGLU(dim, dim * mult), nn.Identity(),
                                 Linear(dim * mult, dim))

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int):
        super().__init__()
        self.attn1 = CrossAttention(dim, dim, heads, dim_head)
        self.ff = FeedForward(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm1 = LayerNorm(dim)
        self.norm2 = LayerNorm(dim)
        self.norm3 = LayerNorm(dim)

    def forward(self, x, context):
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), context)
        return x + self.ff(self.norm3(x))


class SpatialTransformer(nn.Module):
    """proj_in/proj_out around the token blocks: 1x1 convs (SD1.5), or
    Linear layers on the tokens (`use_linear`, SDXL)."""

    def __init__(self, ch: int, context_dim: int, heads: int, dim_head: int,
                 depth: int = 1, use_linear: bool = False):
        super().__init__()
        self.use_linear = use_linear
        self.norm = GroupNorm(ch, 32, eps=1e-6)
        proj = (lambda: Linear(ch, ch)) if use_linear else \
            (lambda: Conv2d(ch, ch, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(ch, context_dim, heads, dim_head)
            for _ in range(depth))
        self.proj_out = proj()

    def forward(self, x, context):
        b, c, h, w = x.shape
        t = self.norm(x)
        if not self.use_linear:
            t = self.proj_in(t)
        t = t.permute(0, 2, 3, 1).reshape(b, h * w, c).contiguous()
        if self.use_linear:
            t = self.proj_in(t)
        for blk in self.transformer_blocks:
            t = blk(t, context)
        if self.use_linear:
            t = self.proj_out(t)
        t = t.reshape(b, h, w, c).permute(0, 3, 1, 2).contiguous()
        if not self.use_linear:
            t = self.proj_out(t)
        return t + x


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb_ch: int, out_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(ch, 32, fuse_silu=True),
                                       nn.Identity(), Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.Identity(), Linear(emb_ch, out_ch))
        self.out_layers = nn.Sequential(
            GroupNorm(out_ch, 32, fuse_silu=True), nn.Identity(), nn.Identity(),
            Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = (Conv2d(ch, out_ch, 1) if ch != out_ch
                                else nn.Identity())

    def forward(self, x, emb):
        h = self.in_layers[2](self.in_layers[0](x))
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None]
        h = self.out_layers[3](self.out_layers[0](h))
        return self.skip_connection(x) + h


class Downsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.op = Conv2d(ch, ch, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class Upsample(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def spatial_transformer(cfg: UNetConfig, ch: int, depth: int):
    heads, dh = _heads_for(ch, cfg)
    return SpatialTransformer(ch, cfg.context_dim, heads, dh, depth,
                              cfg.use_linear_in_transformer)


def encoder_blocks(cfg: UNetConfig, in_channels: int, res_block=ResBlock,
                   transformer=spatial_transformer):
    """The UNet's encoder half, shared with the ControlNet and the video
    UNet (models/video_unet.py, which passes its own `res_block(ch,
    emb_ch, out_ch)` and `transformer(cfg, ch, depth)`): (time_embed,
    input_blocks, middle_block, the channels of each input block's output,
    the downsampling factor at the bottom)."""
    mc = cfg.model_channels
    ted = mc * 4
    depths = cfg.transformer_depth
    time_embed = nn.Sequential(Linear(mc, ted), nn.Identity(), Linear(ted, ted))
    input_blocks = nn.ModuleList(
        [nn.ModuleList([Conv2d(in_channels, mc, 3, padding=1)])])
    chans = [mc]
    ch, ds = mc, 1
    n_levels = len(cfg.channel_mult)
    for level, mult in enumerate(cfg.channel_mult):
        for _ in range(cfg.num_res_blocks):
            layers = [res_block(ch, ted, mc * mult)]
            ch = mc * mult
            if ds in cfg.attention_resolutions:
                layers.append(transformer(cfg, ch, depths[level]))
            input_blocks.append(nn.ModuleList(layers))
            chans.append(ch)
        if level != n_levels - 1:
            input_blocks.append(nn.ModuleList([Downsample(ch)]))
            chans.append(ch)
            ds *= 2
    middle_block = nn.ModuleList([
        res_block(ch, ted, ch),
        transformer(cfg, ch, cfg.transformer_depth_middle),
        res_block(ch, ted, ch)])
    return time_embed, input_blocks, middle_block, chans, ds


def decoder_blocks(cfg: UNetConfig, chans, ds: int, res_block=ResBlock,
                   transformer=spatial_transformer):
    """The UNet's decoder half over the encoder's skip channels `chans`
    (consumed) from the downsampling factor `ds` at the bottom: (the
    output blocks, the channels of the last)."""
    mc = cfg.model_channels
    ch = chans[-1]
    output_blocks = nn.ModuleList()
    for level in reversed(range(len(cfg.channel_mult))):
        out_ch = mc * cfg.channel_mult[level]
        for i in range(cfg.num_res_blocks + 1):
            layers = [res_block(ch + chans.pop(), mc * 4, out_ch)]
            ch = out_ch
            if ds in cfg.attention_resolutions:
                layers.append(transformer(cfg, ch, cfg.transformer_depth[level]))
            if level > 0 and i == cfg.num_res_blocks:
                layers.append(Upsample(ch))
                ds //= 2
            output_blocks.append(nn.ModuleList(layers))
    return output_blocks, ch


def run_layers(layers, h, emb, context):
    """One input/middle/output block: its layers in order."""
    for layer in layers:
        if isinstance(layer, ResBlock):
            h = layer(h, emb)
        elif isinstance(layer, SpatialTransformer):
            h = layer(h, context)
        else:
            h = layer(h)
    return h


class UNetModel(nn.Module):
    """The denoising UNet: forward(x NCHW, t (B,), context (B, L, D),
    control=None, y=None); `y` (B, adm_in_channels) is SDXL's vector
    conditioning."""

    def __init__(self, cfg: UNetConfig):
        super().__init__()
        self.cfg = cfg
        ted = cfg.model_channels * 4
        (self.time_embed, self.input_blocks, self.middle_block, chans,
         ds) = encoder_blocks(cfg, cfg.in_channels)
        if cfg.adm_in_channels:
            self.label_emb = nn.Sequential(nn.Sequential(
                Linear(cfg.adm_in_channels, ted), nn.Identity(),
                Linear(ted, ted)))
        self.output_blocks, ch = decoder_blocks(cfg, chans, ds)
        self.out = nn.Sequential(GroupNorm(ch, 32, fuse_silu=True),
                                 nn.Identity(),
                                 Conv2d(ch, cfg.out_channels, 3, padding=1))

    def forward(self, x, timesteps, context, control=None, y=None):
        """`control`: (one residual per input block, the middle block's
        residual), added to the skips and the middle output as the JAX
        UNet adds them. `y`: the vector conditioning of a UNet with
        adm_in_channels, through label_emb into the time embedding."""
        dtype = self.cfg.dtype
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels).to(dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        if self.cfg.adm_in_channels:
            if y is None:
                raise ValueError("this UNet expects vector conditioning y")
            lab = self.label_emb[0]
            emb = emb + lab[2](F.silu(lab[0](y.to(dtype))))
        h = x.to(dtype)
        context = context.to(dtype)
        hs = []
        for layers in self.input_blocks:
            h = run_layers(layers, h, emb, context)
            hs.append(h)
        h = run_layers(self.middle_block, h, emb, context)
        if control is not None:
            input_res, middle_res = control
            h = h + middle_res.to(h.dtype)
            hs = [hi + ri.to(hi.dtype) for hi, ri in zip(hs, input_res)]
        for layers in self.output_blocks:
            h = torch.cat([h, hs.pop()], dim=1)
            h = run_layers(layers, h, emb, context)
        return self.out[2](self.out[0](h))
