"""MMDiT (SD3's joint-attention diffusion transformer) in PyTorch — the port
of cremage_tpu/models/mmdit.py.

Patchified 16-channel latents (a 2x2 stride-2 convolution), the 192x192
learned position table centre-cropped to the latent's patch grid, the
timestep and pooled-text embedders summed into one conditioning vector,
and `depth` joint blocks: each stream (the text context and the latent
tokens) has its own adaLN modulation, fused qkv (optional RMS qk-norm, as
SD3.5 has it), attention output projection and GELU MLP, and one
attention runs over the concatenated [context; latent] tokens. The last
block's context stream is pre-only: 2 modulations, its qkv, no attn.proj
and no MLP. Velocity prediction, the output unpatchified to the input's
NHWC shape.

Module names follow the SD3 checkpoint keys under `model.diffusion_model.`
(x_embedder.proj, pos_embed, t_embedder.mlp.{0,2}, y_embedder.mlp.{0,2},
context_embedder, joint_blocks.{i}.{context_block,x_block}.
{adaLN_modulation.1, attn.{qkv,proj,ln_q,ln_k}, mlp.{fc1,fc2}},
final_layer.{adaLN_modulation.1,linear}). Activations run in the compute
dtype as in JAX: the affine-free LayerNorms and the qk-norm in float32,
then cast. Every joint attention is kernel K1 on CUDA. The JAX model's
deep-cache modes ("capture", "shallow"), ToMe and sequence-parallel
branches are not ported.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.flux import gelu_tanh, no_affine_ln
from cremage_tpu_torch.models.layers import Conv2d, Linear, timestep_embedding
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    patch_size: int = 2
    in_channels: int = 16
    depth: int = 24
    hidden_size: int = 1536          # 64 * depth for SD3-medium
    num_heads: int = 24
    context_dim: int = 4096          # T5 width (the CLIP concat zero-padded)
    pooled_dim: int = 2048           # CLIP-L + bigG pooled
    pos_embed_max_size: int = 192
    mlp_ratio: int = 4
    qk_norm: bool = False            # SD3.5's RMS qk-norm
    dtype: torch.dtype = torch.bfloat16


def sd3_medium_config(**kw) -> MMDiTConfig:
    return MMDiTConfig(**kw)


def modulate(x, shift, scale):
    """Affine-free LayerNorm, then x (1 + scale) + shift per batch row."""
    return no_affine_ln(x) * (1 + scale[:, None]) + shift[:, None]


def check_full_mode(mode: str) -> None:
    if mode != "full":
        raise NotImplementedError(
            f"mode {mode!r} (deep cache's capture / shallow split, with ToMe "
            f"and the sequence-parallel mesh: ROADMAP M18 / M19) is not "
            f"ported; the port runs mode='full'")


class RMSNorm(nn.Module):
    """The qk-norm: RMS over the head dim in float32 with a float32
    `weight`, cast back."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        x32 = x32 / torch.sqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6)
        return (x32 * self.weight).to(x.dtype)


class JointAttention(nn.Module):
    def __init__(self, cfg: MMDiTConfig, pre_only: bool):
        super().__init__()
        h, d = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
        self.qkv = Linear(h, 3 * h)
        if not pre_only:
            self.proj = Linear(h, h)
        if cfg.qk_norm:
            self.ln_q = RMSNorm(d)
            self.ln_k = RMSNorm(d)


class StreamBlock(nn.Module):
    """One stream of a joint block (its `context_block` or `x_block`)."""

    def __init__(self, cfg: MMDiTConfig, pre_only: bool = False):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.n_mod = 2 if pre_only else 6
        self.adaLN_modulation = nn.ModuleDict(
            {"1": Linear(h, self.n_mod * h)})
        self.attn = JointAttention(cfg, pre_only)
        if not pre_only:
            self.mlp = nn.ModuleDict({"fc1": Linear(h, h * cfg.mlp_ratio),
                                      "fc2": Linear(h * cfg.mlp_ratio, h)})

    def mods(self, vec):
        return self.adaLN_modulation["1"](F.silu(vec)).chunk(self.n_mod, -1)

    def qkv(self, x, shift, scale):
        """-> q, k, v, each (B, N, H, D)."""
        cfg = self.cfg
        qkv = self.attn.qkv(modulate(x, shift, scale))
        b, n, _ = qkv.shape
        qkv = qkv.view(b, n, 3, cfg.num_heads, cfg.hidden_size // cfg.num_heads)
        q, k, v = qkv.unbind(2)
        if cfg.qk_norm:
            q, k = self.attn.ln_q(q), self.attn.ln_k(k)
        return q, k, v

    def out(self, x, attended, mods):
        _, _, gate_msa, shift_mlp, scale_mlp, gate_mlp = mods
        y = x + gate_msa[:, None] * self.attn.proj(attended)
        m = gelu_tanh(self.mlp["fc1"](modulate(y, shift_mlp, scale_mlp)))
        return y + gate_mlp[:, None] * self.mlp["fc2"](m)


class JointBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, final: bool = False):
        super().__init__()
        self.cfg = cfg
        self.final = final
        self.context_block = StreamBlock(cfg, pre_only=final)
        self.x_block = StreamBlock(cfg)

    def forward(self, ctx, x, vec):
        """-> (ctx, x); ctx is None after the final block."""
        c_mods, x_mods = self.context_block.mods(vec), self.x_block.mods(vec)
        cq, ck, cv = self.context_block.qkv(ctx, c_mods[0], c_mods[1])
        xq, xk, xv = self.x_block.qkv(x, x_mods[0], x_mods[1])
        # torch.cat gives the kernel the contiguous q, k and v it takes
        att = attention(torch.cat([cq, xq], 1), torch.cat([ck, xk], 1),
                        torch.cat([cv, xv], 1))
        b, n = att.shape[:2]
        att = att.reshape(b, n, self.cfg.hidden_size)
        nc = ctx.shape[1]
        x = self.x_block.out(x, att[:, nc:], x_mods)
        ctx = None if self.final else self.context_block.out(
            ctx, att[:, :nc], c_mods)
        return ctx, x


class FinalLayer(nn.Module):
    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        h = cfg.hidden_size
        self.adaLN_modulation = nn.ModuleDict({"1": Linear(h, 2 * h)})
        self.linear = Linear(h, cfg.patch_size ** 2 * cfg.in_channels)

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation["1"](F.silu(vec)).chunk(2, -1)
        return self.linear(modulate(x, shift, scale))


class PatchEmbed(nn.Module):
    def __init__(self, in_channels: int, hidden: int, p: int):
        super().__init__()
        self.proj = Conv2d(in_channels, hidden, p, stride=p)

    def forward(self, x):
        """x (B, H, W, C) NHWC -> tokens (B, H/p * W/p, hidden)."""
        y = self.proj(x.permute(0, 3, 1, 2))
        return y.flatten(2).transpose(1, 2)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.mlp = nn.ModuleDict({"0": Linear(in_dim, hidden),
                                  "2": Linear(hidden, hidden)})

    def forward(self, x):
        return self.mlp["2"](F.silu(self.mlp["0"](x)))


def unpatchify(out: torch.Tensor, b: int, hh: int, ww: int, p: int,
               c: int) -> torch.Tensor:
    """(B, hp * wp, p * p * c) -> (B, H, W, c), patches in (dy, dx, c)
    order."""
    out = out.reshape(b, hh // p, ww // p, p, p, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, hh, ww, c)


class MMDiT(nn.Module):
    """forward(x (B, H, W, 16) NHWC latents, t (B,) in [0, 1000], context
    (B, L, context_dim), pooled (B, pooled_dim)) -> velocity (B, H, W, 16)
    in the compute dtype."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        self.cfg = cfg
        h, m = cfg.hidden_size, cfg.pos_embed_max_size
        self.x_embedder = PatchEmbed(cfg.in_channels, h, cfg.patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, m * m, h))
        self.t_embedder = MLPEmbedder(256, h)
        self.y_embedder = MLPEmbedder(cfg.pooled_dim, h)
        self.context_embedder = Linear(cfg.context_dim, h)
        self.joint_blocks = nn.ModuleList(
            JointBlock(cfg, final=(i == cfg.depth - 1))
            for i in range(cfg.depth))
        self.final_layer = FinalLayer(cfg)

    def cropped_pos(self, hp: int, wp: int) -> torch.Tensor:
        """The hp x wp centre crop of the position grid, (1, hp * wp, D)."""
        m, d = self.cfg.pos_embed_max_size, self.cfg.hidden_size
        top, left = (m - hp) // 2, (m - wp) // 2
        grid = self.pos_embed.view(m, m, d)[top:top + hp, left:left + wp]
        return grid.reshape(1, hp * wp, d)

    def forward(self, x, t, context, pooled, mode: str = "full"):
        check_full_mode(mode)
        cfg, dt = self.cfg, self.cfg.dtype
        p = cfg.patch_size
        b, hh, ww, _ = x.shape
        tokens = self.x_embedder(x.to(dt))
        tokens = tokens + self.cropped_pos(hh // p, ww // p).to(dt)
        vec = self.t_embedder(timestep_embedding(t, 256).to(dt)) + \
            self.y_embedder(pooled.to(dt))
        ctx = self.context_embedder(context.to(dt))
        for blk in self.joint_blocks:
            ctx, tokens = blk(ctx, tokens, vec)
        out = self.final_layer(tokens, vec)
        return unpatchify(out, b, hh, ww, p, cfg.in_channels)
