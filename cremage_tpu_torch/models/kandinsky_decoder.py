"""Kandinsky 2.2's decoder UNet in PyTorch, NCHW inside — the port of
cremage_tpu/models/kandinsky_decoder.py, `mode="full"` without ToMe.

Architecture contract (diffusers' UNet2DConditionModel of the Kandinsky
2.2 decoder, as the JAX module gives it):
- `ScaleShiftResBlock`: norm1 with SiLU (kernel K2 with SiLU fused), the
  in-block 2x2 average pool or nearest 2x upsampling of both branches,
  conv1, norm2 (K2 without SiLU) followed by h * (1 + scale) + shift from
  the time embedding, SiLU, conv2, a 1x1 shortcut where the widths differ;
- `AddedKVAttention`: group_norm (K2) over the spatial stream, q from it,
  keys and values [add_k / add_v of the context tokens; to_k / to_v of the
  stream] concatenated along the key axis, one unmasked attention (kernel
  K1, at Nk = Nq + 10 for the 10 context tokens), to_out, the residual;
- `KandinskyUNet`: the first level plain (no attention), attention at the
  others and in the middle, downsampling and upsampling resnets,
  conv_norm_out (K2 with SiLU), and conv_out in float32 with 8 output
  channels ([eps, variance]; `kandinsky_decoder_eps` keeps the first
  half).

Module names follow the diffusers checkpoint keys (down_blocks.N.resnets.M,
...attentions.M.add_k_proj, ...downsamplers.0, mid_block.*,
up_blocks.N.upsamplers.0, conv_norm_out), which the JAX module's names
flatten to; the image heads are models/kandinsky.py
`KandinskyImageConditioner`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import (
    Conv2d, Conv2dF32, GroupNorm, Linear, timestep_embedding,
)
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class KandinskyUNetConfig:
    in_channels: int = 4              # 9 for the inpaint decoder
    out_channels: int = 8             # eps + learned variance
    block_out_channels: Tuple[int, ...] = (384, 768, 1152, 1536)
    layers_per_block: int = 3
    context_dim: int = 768            # conditioner token width
    attention_head_dim: int = 64
    first_block_plain: bool = True
    dtype: torch.dtype = torch.bfloat16

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


class ScaleShiftResBlock(nn.Module):
    def __init__(self, cin: int, cout: int, ted: int,
                 sample: Optional[str] = None):
        super().__init__()
        self.sample = sample              # None | "down" | "up"
        self.norm1 = GroupNorm(cin, 32, fuse_silu=True)
        self.conv1 = Conv2d(cin, cout, 3, padding=1)
        self.time_emb_proj = Linear(ted, 2 * cout)
        self.norm2 = GroupNorm(cout, 32)
        self.conv2 = Conv2d(cout, cout, 3, padding=1)
        self.conv_shortcut = Conv2d(cin, cout, 1) if cin != cout else None

    def forward(self, x, emb):
        h = self.norm1(x)
        if self.sample == "down":
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        elif self.sample == "up":
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        h = self.conv1(h)
        scale, shift = self.time_emb_proj(F.silu(emb))[:, :, None, None].chunk(
            2, dim=1)
        h = self.norm2(h) * (1 + scale) + shift
        h = self.conv2(F.silu(h))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AddedKVAttention(nn.Module):
    def __init__(self, c: int, context_dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.group_norm = GroupNorm(c, 32)
        self.to_q = Linear(c, c)
        self.to_k = Linear(c, c)
        self.to_v = Linear(c, c)
        self.add_k_proj = Linear(context_dim, c)
        self.add_v_proj = Linear(context_dim, c)
        self.to_out = nn.ModuleList([Linear(c, c)])

    def forward(self, x, ctx):
        b, c, hh, ww = x.shape
        n, d = hh * ww, c // self.heads
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(b, n, c)
        ctx = ctx.to(x.dtype)
        # torch.cat returns new contiguous tensors, as the kernel takes them
        k = torch.cat([self.add_k_proj(ctx), self.to_k(h)], dim=1)
        v = torch.cat([self.add_v_proj(ctx), self.to_v(h)], dim=1)
        m = k.shape[1]
        a = attention(self.to_q(h).view(b, n, self.heads, d),
                      k.view(b, m, self.heads, d), v.view(b, m, self.heads, d))
        out = self.to_out[0](a.reshape(b, n, c))
        return x + out.reshape(b, hh, ww, c).permute(0, 3, 1, 2).contiguous()


class _Block(nn.Module):
    """One level of diffusers' down or up blocks: resnets, attentions (not
    at the plain level) and a resampling resnet (not at the level's end)."""

    def __init__(self, resnets, attentions, resample, kind):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resample is not None:
            setattr(self, kind, nn.ModuleList([resample]))

    def layers(self):
        atts = getattr(self, "attentions", None)
        return [(r, atts[i] if atts is not None else None)
                for i, r in enumerate(self.resnets)]


class _Mid(nn.Module):
    def __init__(self, c: int, ted: int, context_dim: int, heads: int):
        super().__init__()
        self.resnets = nn.ModuleList([ScaleShiftResBlock(c, c, ted),
                                      ScaleShiftResBlock(c, c, ted)])
        self.attentions = nn.ModuleList([AddedKVAttention(c, context_dim,
                                                          heads)])


class _TimeEmbedding(nn.Module):
    def __init__(self, cin: int, ted: int):
        super().__init__()
        self.linear_1 = Linear(cin, ted)
        self.linear_2 = Linear(ted, ted)


class KandinskyUNet(nn.Module):
    """forward(latents (B, h, w, in) NHWC, t (B,), context tokens (B, M,
    context_dim), y = the conditioner's time vector (B, time_embed_dim))
    -> (B, h, w, out_channels) float32."""

    def __init__(self, cfg: KandinskyUNetConfig):
        super().__init__()
        self.cfg = cfg
        boc, ted, cd = cfg.block_out_channels, cfg.time_embed_dim, cfg.context_dim
        n = len(boc)
        self.time_embedding = _TimeEmbedding(boc[0], ted)
        self.conv_in = Conv2d(cfg.in_channels, boc[0], 3, padding=1)

        def heads(c):
            return c // cfg.attention_head_dim

        def plain(lv):
            return cfg.first_block_plain and lv == 0

        chans, cur, down = [boc[0]], boc[0], []
        for lv, c in enumerate(boc):
            res, atts = [], []
            for _ in range(cfg.layers_per_block):
                res.append(ScaleShiftResBlock(cur, c, ted))
                if not plain(lv):
                    atts.append(AddedKVAttention(c, cd, heads(c)))
                cur = c
                chans.append(c)
            sampler = None
            if lv != n - 1:
                sampler = ScaleShiftResBlock(c, c, ted, sample="down")
                chans.append(c)
            down.append(_Block(res, atts, sampler, "downsamplers"))
        self.down_blocks = nn.ModuleList(down)
        self.mid_block = _Mid(boc[-1], ted, cd, heads(boc[-1]))
        up = []
        for lv in reversed(range(n)):
            c = boc[lv]
            res, atts = [], []
            for _ in range(cfg.layers_per_block + 1):
                res.append(ScaleShiftResBlock(cur + chans.pop(), c, ted))
                if not plain(lv):
                    atts.append(AddedKVAttention(c, cd, heads(c)))
                cur = c
            sampler = (ScaleShiftResBlock(c, c, ted, sample="up")
                       if lv != 0 else None)
            up.append(_Block(res, atts, sampler, "upsamplers"))
        self.up_blocks = nn.ModuleList(up)
        self.conv_norm_out = GroupNorm(boc[0], 32, fuse_silu=True)
        self.conv_out = Conv2dF32(boc[0], cfg.out_channels, 3, padding=1)

    def forward(self, x, timesteps, context, y=None):
        cfg = self.cfg
        dt = cfg.dtype
        te = self.time_embedding
        emb = te.linear_1(timestep_embedding(
            timesteps, cfg.block_out_channels[0]).to(dt))
        emb = te.linear_2(F.silu(emb))
        if y is not None:
            emb = emb + y.to(dt)
        context = context.to(dt)
        h = self.conv_in(x.permute(0, 3, 1, 2).to(dt).contiguous())
        hs = [h]
        for blk in self.down_blocks:
            for res, att in blk.layers():
                h = res(h, emb)
                if att is not None:
                    h = att(h, context)
                hs.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h, emb)
                hs.append(h)
        mid = self.mid_block
        h = mid.resnets[0](h, emb)
        h = mid.attentions[0](h, context)
        h = mid.resnets[1](h, emb)
        for blk in self.up_blocks:
            for res, att in blk.layers():
                h = res(torch.cat([h, hs.pop()], dim=1), emb)
                if att is not None:
                    h = att(h, context)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h, emb)
        h = self.conv_out(self.conv_norm_out(h))
        return h.permute(0, 2, 3, 1)


def kandinsky_decoder_eps(out: torch.Tensor) -> torch.Tensor:
    """The decoder predicts [eps, variance] along channels; samplers use
    the eps half."""
    return out[..., : out.shape[-1] // 2]
