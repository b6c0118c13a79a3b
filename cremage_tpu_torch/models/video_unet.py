"""SVD's video UNet in PyTorch, NCHW over (B*T) frames, bf16 compute / fp32
norms — the port of cremage_tpu/models/video_unet.py, `mode="full"` only.

Architecture contract (sgm VideoUNet, configs/inference/svd.yaml):
- every ResBlock is a VideoResBlock: the spatial ResBlock (its keys at the
  block's own scope), then a temporal ResBlock (`time_stack`: (3, 1, 1)
  convolutions over (T, H, W) and a per-frame time embedding) blended
  with it by an AlphaBlender (`time_mixer`);
- every SpatialTransformer is a SpatialVideoTransformer: after each
  spatial block (models/unet.py BasicTransformerBlock), a
  VideoTransformerBlock (`time_stack.{d}`) over the frame position
  embedding's sum attends over the T frames of each pixel (plain torch,
  as JAX runs it: an einsum), then over the first frame's context (K1 at
  one key), and its output is blended back by `time_mixer`;
- in_channels 8 (the latent and the conditioning frame's latent),
  context_dim 1024 (the CLIP-H image embedding, one token), adm 768 (the
  fps_id / motion_bucket_id / cond_aug Fourier vectors).

Activations are (B*T, C, H, W); the temporal layers view them as
(B, T, ...). The AlphaBlenders blend in float32 and cast back. The
temporal convolutions accumulate in float32, round to the compute dtype,
then add the bias in it, as JAX orders them; they are `F.conv3d` (JAX runs
`lax.conv_general_dilated` there, not a Pallas kernel). Every GroupNorm
goes through kernel K2, every unmasked spatial and cross attention
through K1. DeepCache's capture / shallow modes and ToMe are not ported.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import (
    Conv2d, GroupNorm, LayerNorm, Linear, timestep_embedding,
)
from cremage_tpu_torch.models.unet import (
    BasicTransformerBlock, CrossAttention, FeedForward, ResBlock, UNetConfig,
    _heads_for, decoder_blocks, encoder_blocks,
)


def svd_unet_config(**kw) -> UNetConfig:
    """configs/inference/svd.yaml network_config."""
    return UNetConfig(
        in_channels=8, out_channels=4, model_channels=320,
        attention_resolutions=(4, 2, 1), channel_mult=(1, 2, 4, 4),
        num_head_channels=64, num_heads=-1,
        transformer_depth=(1, 1, 1, 1), transformer_depth_middle=1,
        context_dim=1024, adm_in_channels=768,
        use_linear_in_transformer=True, **kw)


class AlphaBlender(nn.Module):
    """sgm's "learned_with_images" blend: alpha = sigmoid(mix_factor), 1
    for the frames `image_only` ((B, T) bool) marks; alpha * spatial +
    (1 - alpha) * temporal in float32, cast to the spatial input's
    dtype."""

    def __init__(self, init_alpha: float = 0.5):
        super().__init__()
        self.mix_factor = nn.Parameter(torch.tensor([init_alpha]))

    def forward(self, x_spatial, x_temporal, image_only=None):
        alpha = torch.sigmoid(self.mix_factor.float())[0]
        if image_only is not None:
            a = torch.where(image_only.reshape(-1).to(x_spatial.device),
                            torch.ones((), device=x_spatial.device), alpha)
            alpha = a.reshape((-1,) + (1,) * (x_spatial.ndim - 1))
        return (alpha * x_spatial.float()
                + (1.0 - alpha) * x_temporal.float()).to(x_spatial.dtype)


class Conv3x1x1(nn.Conv3d):
    """A (3, 1, 1) convolution over (T, H, W) of (B*T, C, H, W) frames:
    accumulated in float32 and rounded to the input dtype, then the bias
    added in that dtype. The output is contiguous (over one video the
    frames-first view of the convolution's output is a strided view,
    which K2 refuses)."""

    def __init__(self, ch: int, out_ch: int):
        super().__init__(ch, out_ch, (3, 1, 1), padding=(1, 0, 0))

    def forward(self, x, frames: int):
        bt, c, h, w = x.shape
        v = x.view(bt // frames, frames, c, h, w).transpose(1, 2)
        y = F.conv3d(v, self.weight.to(x.dtype), None, 1, self.padding)
        y = y + self.bias.to(x.dtype)[:, None, None, None]
        return y.transpose(1, 2).contiguous().view(bt, -1, h, w)


class TemporalResBlock(nn.Module):
    """`time_stack` of a VideoResBlock: GroupNorm+SiLU (K2), a (3, 1, 1)
    convolution, the per-frame time embedding, GroupNorm+SiLU, a (3, 1, 1)
    convolution, the residual."""

    def __init__(self, ch: int, emb_ch: int):
        super().__init__()
        self.in_layers = nn.Sequential(GroupNorm(ch, 32, fuse_silu=True),
                                       nn.Identity(), Conv3x1x1(ch, ch))
        self.emb_layers = nn.Sequential(nn.Identity(), Linear(emb_ch, ch))
        self.out_layers = nn.Sequential(
            GroupNorm(ch, 32, fuse_silu=True), nn.Identity(), nn.Identity(),
            Conv3x1x1(ch, ch))

    def forward(self, x, emb, frames: int):
        h = self.in_layers[2](self.in_layers[0](x), frames)
        h = h + self.emb_layers[1](F.silu(emb))[:, :, None, None]
        h = self.out_layers[3](self.out_layers[0](h), frames)
        return x + h


class VideoResBlock(ResBlock):
    """The spatial ResBlock, then `time_stack` blended in by `time_mixer`."""

    def __init__(self, ch: int, emb_ch: int, out_ch: int, frames: int):
        super().__init__(ch, emb_ch, out_ch)
        self.frames = frames
        self.time_stack = TemporalResBlock(out_ch, emb_ch)
        self.time_mixer = AlphaBlender()

    def forward(self, x, emb, image_only=None):
        x = super().forward(x, emb)
        return self.time_mixer(x, self.time_stack(x, emb, self.frames),
                               image_only)


class TemporalSelfAttention(nn.Module):
    """Self-attention over the frame axis of (B*T, S, C) tokens, per
    (batch, pixel, head): fp32 logits and softmax, probabilities cast to
    v's dtype, the product accumulated in fp32, as JAX's einsums. Its
    batch B*S*heads (92,160 at SVD's first level) exceeds K1's grid, and
    JAX runs no Pallas kernel here."""

    def __init__(self, dim: int, heads: int, dim_head: int, frames: int):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.frames = heads, dim_head, frames
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = nn.Sequential(Linear(inner, dim), nn.Identity())

    def forward(self, x):
        bt, s, c = x.shape
        t = self.frames
        shape = (bt // t, t, s, self.heads, self.dim_head)
        q = self.to_q(x).view(shape)
        k = self.to_k(x).view(shape)
        v = self.to_v(x).view(shape)
        logits = torch.einsum("btshd,bushd->bshtu", q.float(), k.float()) \
            * (self.dim_head ** -0.5)
        probs = torch.softmax(logits, dim=-1)
        out = torch.einsum("bshtu,bushd->btshd", probs.to(v.dtype).float(),
                           v.float()).to(x.dtype)
        return self.to_out[0](out.reshape(bt, s, -1))


class VideoTransformerBlock(nn.Module):
    """`time_stack.{d}`: ff_in, the temporal self-attention, attention over
    the first frame's context (repeated per frame; K1), ff; each after a
    LayerNorm, each residual."""

    def __init__(self, dim: int, context_dim: int, heads: int, dim_head: int,
                 frames: int):
        super().__init__()
        self.frames = frames
        self.norm_in = LayerNorm(dim)
        self.ff_in = FeedForward(dim)
        self.norm1 = LayerNorm(dim)
        self.attn1 = TemporalSelfAttention(dim, heads, dim_head, frames)
        self.norm2 = LayerNorm(dim)
        self.attn2 = CrossAttention(dim, context_dim, heads, dim_head)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, time_context):
        x = x + self.ff_in(self.norm_in(x))
        x = x + self.attn1(self.norm1(x))
        tc = time_context.repeat_interleave(self.frames, dim=0)
        x = x + self.attn2(self.norm2(x), tc)
        return x + self.ff(self.norm3(x))


class SpatialVideoTransformer(nn.Module):
    """GroupNorm (K2), Linear proj_in on the tokens, per depth a spatial
    BasicTransformerBlock and a VideoTransformerBlock over its output plus
    the frame position embedding (`time_pos_embed`), blended by
    `time_mixer`; proj_out, the residual."""

    def __init__(self, ch: int, context_dim: int, heads: int, dim_head: int,
                 frames: int, depth: int = 1):
        super().__init__()
        self.frames = frames
        self.norm = GroupNorm(ch, 32, eps=1e-6)
        self.proj_in = Linear(ch, ch)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(ch, context_dim, heads, dim_head)
            for _ in range(depth))
        self.time_stack = nn.ModuleList(
            VideoTransformerBlock(ch, context_dim, heads, dim_head, frames)
            for _ in range(depth))
        self.time_pos_embed = nn.Sequential(Linear(ch, ch * 4), nn.Identity(),
                                            Linear(ch * 4, ch))
        self.time_mixer = AlphaBlender()
        self.proj_out = Linear(ch, ch)

    def forward(self, x, context, time_context, image_only=None):
        bt, c, hh, ww = x.shape
        t = self.frames
        h = self.norm(x).permute(0, 2, 3, 1).reshape(bt, hh * ww, c)
        h = self.proj_in(h.contiguous())
        frames = torch.arange(t, dtype=torch.float32, device=x.device)
        emb = timestep_embedding(frames, c).to(h.dtype)
        emb = self.time_pos_embed[2](F.silu(self.time_pos_embed[0](emb)))
        pos = emb.repeat(bt // t, 1)[:, None, :]
        for block, video in zip(self.transformer_blocks, self.time_stack):
            h = block(h, context)
            h = self.time_mixer(h, video(h + pos, time_context), image_only)
        h = self.proj_out(h)
        return h.reshape(bt, hh, ww, c).permute(0, 3, 1, 2).contiguous() + x


class VideoUNet(nn.Module):
    """forward(x (B*T, 8, H, W), timesteps (B*T,), context (B*T, 1, D),
    y (B*T, adm), image_only=None) -> (B*T, 4, H, W); T = num_frames."""

    def __init__(self, cfg: UNetConfig, num_frames: int = 14):
        super().__init__()
        self.cfg = cfg
        self.num_frames = num_frames

        def res_block(ch, emb_ch, out_ch):
            return VideoResBlock(ch, emb_ch, out_ch, num_frames)

        def transformer(cfg, ch, depth):
            heads, dh = _heads_for(ch, cfg)
            return SpatialVideoTransformer(ch, cfg.context_dim, heads, dh,
                                           num_frames, depth)

        ted = cfg.model_channels * 4
        (self.time_embed, self.input_blocks, self.middle_block, chans,
         ds) = encoder_blocks(cfg, cfg.in_channels, res_block, transformer)
        self.label_emb = nn.Sequential(nn.Sequential(
            Linear(cfg.adm_in_channels, ted), nn.Identity(), Linear(ted, ted)))
        self.output_blocks, ch = decoder_blocks(cfg, chans, ds, res_block,
                                                transformer)
        self.out = nn.Sequential(GroupNorm(ch, 32, fuse_silu=True),
                                 nn.Identity(),
                                 Conv2d(ch, cfg.out_channels, 3, padding=1))

    @staticmethod
    def _run(layers, h, emb, context, time_context, image_only):
        for layer in layers:
            if isinstance(layer, VideoResBlock):
                h = layer(h, emb, image_only)
            elif isinstance(layer, SpatialVideoTransformer):
                h = layer(h, context, time_context, image_only)
            else:
                h = layer(h)
        return h

    def forward(self, x, timesteps, context, y,
                image_only: Optional[torch.Tensor] = None):
        dtype = self.cfg.dtype
        t_emb = timestep_embedding(timesteps, self.cfg.model_channels).to(dtype)
        emb = self.time_embed[2](F.silu(self.time_embed[0](t_emb)))
        lab = self.label_emb[0]
        emb = emb + lab[2](F.silu(lab[0](y.to(dtype))))
        h = x.to(dtype)
        context = context.to(dtype)
        time_context = context[::self.num_frames]
        args = (emb, context, time_context, image_only)
        hs = []
        for layers in self.input_blocks:
            h = self._run(layers, h, *args)
            hs.append(h)
        h = self._run(self.middle_block, h, *args)
        for layers in self.output_blocks:
            h = self._run(layers, torch.cat([h, hs.pop()], dim=1), *args)
        return self.out[2](self.out[0](h))
