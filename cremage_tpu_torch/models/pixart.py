"""PixArt-Σ DiT (cross-attention transformer with adaLN-single) in PyTorch —
the port of cremage_tpu/models/pixart.py.

Patchified 4-channel SD-VAE latents plus a host-computed 2-D sincos
position table, the T5 caption tokens through a 2-layer projection, one
shared 6 x hidden modulation from the timestep (`t_block`) plus each
block's learned `scale_shift_table`, and blocks of self-attention (fused
qkv), unmodulated cross-attention over the caption (q, fused kv) and a
GELU MLP. Eps prediction with learned sigma: 8 output channels, of which
the pipeline keeps the first 4.

Module names follow the PixArt repository's keys, which
io/diffusers_keys.py `pixart_from_diffusers` makes of a diffusers file
(x_embedder.proj, t_embedder.mlp.{0,2}, t_block.1,
y_embedder.y_proj.{fc1,fc2}, blocks.{i}.{scale_shift_table,
attn.{qkv,proj}, cross_attn.{q_linear,kv_linear,proj}, mlp.{fc1,fc2}},
final_layer.{scale_shift_table,linear}). Activations run in the compute
dtype as in JAX: the LayerNorms and the modulation sums in float32, then
cast. Both attentions are kernel K1 on CUDA (PixArt-Σ XL: 16 heads of 72,
padded to the kernel's 80). The JAX model's deep-cache modes, ToMe and
sequence-parallel branches are not ported.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.flux import gelu_tanh, no_affine_ln
from cremage_tpu_torch.models.layers import Linear, timestep_embedding
from cremage_tpu_torch.models.mmdit import (
    MLPEmbedder, PatchEmbed, check_full_mode, unpatchify,
)
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class PixArtConfig:
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8            # eps + learned sigma
    hidden_size: int = 1152
    depth: int = 28
    num_heads: int = 16
    context_dim: int = 4096          # T5
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16


def pixart_sigma_xl_config(**kw) -> PixArtConfig:
    return PixArtConfig(**kw)


def sincos_2d(embed_dim: int, h: int, w: int) -> np.ndarray:
    """2-D sincos position table (h * w, embed_dim): [sin, cos] of the row
    index, then of the column index, float64 on the host, returned as
    float32 (the JAX module's table)."""
    def one_d(dim, pos):
        omega = 1.0 / 10000 ** (np.arange(dim // 2, dtype=np.float64)
                                / (dim / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    gw, gh = np.meshgrid(np.arange(w, dtype=np.float64),
                         np.arange(h, dtype=np.float64))
    return np.concatenate([one_d(embed_dim // 2, gh), one_d(embed_dim // 2, gw)],
                          axis=1).astype(np.float32)


class SelfAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.qkv = Linear(hidden, 3 * hidden)
        self.proj = Linear(hidden, hidden)


class CrossAttention(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.q_linear = Linear(hidden, hidden)
        self.kv_linear = Linear(hidden, 2 * hidden)
        self.proj = Linear(hidden, hidden)


class PixArtBlock(nn.Module):
    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.scale_shift_table = nn.Parameter(torch.zeros(6, h))
        self.attn = SelfAttention(h)
        self.cross_attn = CrossAttention(h)
        self.mlp = nn.ModuleDict({"fc1": Linear(h, h * cfg.mlp_ratio),
                                  "fc2": Linear(h * cfg.mlp_ratio, h)})

    def forward(self, x, y, t6):
        """x (B, N, hidden) tokens, y (B, M, hidden) caption, t6 (B, 6,
        hidden) float32."""
        cfg = self.cfg
        heads, d = cfg.num_heads, cfg.hidden_size // cfg.num_heads
        mods = self.scale_shift_table[None].float() + t6
        shift_msa, scale_msa, gate_msa, shift_mlp, scale_mlp, gate_mlp = (
            mods[:, i][:, None].to(x.dtype) for i in range(6))
        b, n, _ = x.shape
        qkv = self.attn.qkv(no_affine_ln(x) * (1 + scale_msa) + shift_msa)
        q, k, v = (t.contiguous() for t in
                   qkv.view(b, n, 3, heads, d).unbind(2))
        att = attention(q, k, v).reshape(b, n, cfg.hidden_size)
        x = x + gate_msa * self.attn.proj(att)

        # cross-attention, unmodulated (the PixArt convention)
        q = self.cross_attn.q_linear(x).view(b, n, heads, d)
        kv = self.cross_attn.kv_linear(y).view(b, y.shape[1], 2, heads, d)
        k, v = (t.contiguous() for t in kv.unbind(2))
        catt = attention(q, k, v).reshape(b, n, cfg.hidden_size)
        x = x + self.cross_attn.proj(catt)

        m = self.mlp["fc1"](no_affine_ln(x) * (1 + scale_mlp) + shift_mlp)
        return x + gate_mlp * self.mlp["fc2"](gelu_tanh(m))


class FinalLayer(nn.Module):
    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.scale_shift_table = nn.Parameter(torch.zeros(2, cfg.hidden_size))
        self.linear = Linear(cfg.hidden_size,
                             cfg.patch_size ** 2 * cfg.out_channels)

    def forward(self, x, t_vec):
        t2 = self.scale_shift_table[None].float() + \
            t_vec.float()[:, None].expand(-1, 2, -1)
        shift, scale = t2[:, 0][:, None], t2[:, 1][:, None]
        return self.linear(no_affine_ln(x) * (1 + scale.to(x.dtype))
                           + shift.to(x.dtype))


class CaptionProjection(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.y_proj = nn.ModuleDict({"fc1": Linear(in_dim, hidden),
                                     "fc2": Linear(hidden, hidden)})

    def forward(self, y):
        return self.y_proj["fc2"](gelu_tanh(self.y_proj["fc1"](y)))


class PixArt(nn.Module):
    """forward(x (B, H, W, 4) NHWC latents, t (B,) DDPM timesteps, y (B, L,
    context_dim) caption) -> (B, H, W, out_channels) in the compute
    dtype."""

    def __init__(self, cfg: PixArtConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.x_embedder = PatchEmbed(cfg.in_channels, h, cfg.patch_size)
        self.t_embedder = MLPEmbedder(256, h)
        self.t_block = nn.ModuleDict({"1": Linear(h, 6 * h)})
        self.y_embedder = CaptionProjection(cfg.context_dim, h)
        self.blocks = nn.ModuleList(PixArtBlock(cfg) for _ in range(cfg.depth))
        self.final_layer = FinalLayer(cfg)
        self._pos = {}

    def pos_table(self, hp: int, wp: int, device) -> torch.Tensor:
        """`sincos_2d` of the patch grid in the compute dtype on `device`,
        memoized: the JAX module's table is a constant of its compiled
        program, and recomputing the float64 table on the host at every
        evaluation left the card idle most of a 1024^2 request."""
        key = (hp, wp, str(device))
        if key not in self._pos:
            self._pos[key] = torch.from_numpy(sincos_2d(
                self.cfg.hidden_size, hp, wp)).to(device, self.cfg.dtype)
        return self._pos[key]

    def forward(self, x, t, y, mode: str = "full"):
        check_full_mode(mode)
        cfg, dt = self.cfg, self.cfg.dtype
        p = cfg.patch_size
        b, hh, ww, _ = x.shape
        tokens = self.x_embedder(x.to(dt))
        tokens = tokens + self.pos_table(hh // p, ww // p, tokens.device)[None]
        t_vec = self.t_embedder(timestep_embedding(t, 256).to(dt))
        t6 = self.t_block["1"](F.silu(t_vec)).reshape(
            b, 6, cfg.hidden_size).float()
        y = self.y_embedder(y.to(dt))
        for blk in self.blocks:
            tokens = blk(tokens, y, t6)
        out = self.final_layer(tokens, t_vec)
        return unpatchify(out, b, hh, ww, p, cfg.out_channels)
