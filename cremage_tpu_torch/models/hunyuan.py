"""Hunyuan-DiT (a U-shaped DiT over two bilingual text streams) in PyTorch —
the port of cremage_tpu/models/hunyuan.py.

Patchified 4-channel SD-VAE latents (a 2x2 stride-2 convolution), 2-D RoPE
over the (y, x) halves of the head dim (models/flux.py `rope_freqs` and
`apply_rope`, theta 10,000), and `depth` blocks, each with
AdaLayerNormShift (a timestep shift added after norm1), self-attention
over a fused qkv with per-head q/k LayerNorms, cross-attention over the
joint text stream [77 CLIP (BERT) tokens; 256 mT5 tokens through
`text_embedder`] with per-head q/k LayerNorms, and a tanh-GELU MLP to
int(hidden * 4.3) (6054 at 1408). U-ViT long skips: block i of the second
half takes skip_linear(skip_norm([x; the output of block depth - 1 - i])).
The timestep embedding plus `extra_embedder` of the attention-pooled mT5
stream conditions every block (the pool: the mean mT5 token prepended, a
learned positional table added, one query from the mean token over all
257). The final AdaLayerNormContinuous (affine-free, eps 1e-6, [scale,
shift]), then `final_linear` and the unpatchify to 8 channels (v and the
learned sigma; the pipeline keeps the first 4). `text_embedding_padding`
is loaded and not used, as in JAX.

Module names are those cremage_tpu/io/diffusers_keys.py
`hunyuan_from_diffusers` makes of a diffusers HunyuanDiT2DModel file (and
io/diffusers_keys.py's copy of it here): x_embedder.proj,
t_embedder.mlp_{0,2}, pooler.{positional_embedding,q_proj,k_proj,v_proj,
c_proj}, extra_embedder.fc{1,2}, text_embedder.linear_{1,2},
text_embedding_padding, blocks.{i}.{norm1,default_modulation_1,attn1_qkv,
attn1_{q,k}_norm,attn1_proj,norm2,attn2_q,attn2_kv,attn2_{q,k}_norm,
attn2_proj,norm3,mlp_fc1,mlp_fc2,skip_norm,skip_linear}, final_adaLN_1,
final_linear. Activations run in the compute dtype as in JAX: the
LayerNorms and RoPE in float32, then cast; `silu_fp32` where JAX has it.
Every attention is kernel K1 on CUDA: the self- and cross-attention at
d = 88 (padded to 96), the pool at d = 256. The JAX model's deep-cache
modes, ToMe and sequence-parallel branches are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.flux import (
    apply_rope, gelu_tanh, no_affine_ln, rope_freqs,
)
from cremage_tpu_torch.models.layers import LayerNorm, Linear, timestep_embedding
from cremage_tpu_torch.models.mmdit import PatchEmbed, check_full_mode, unpatchify
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class HunyuanConfig:
    patch_size: int = 2
    in_channels: int = 4
    out_channels: int = 8            # v + learned sigma
    hidden_size: int = 1408
    depth: int = 40
    num_heads: int = 16
    clip_dim: int = 1024             # joint text-token width
    mt5_dim: int = 2048
    pooled_dim: int = 1024           # the attention pool's output width
    pooler_heads: int = 8
    mlp_ratio: float = 4.3
    text_len: int = 77               # CLIP (BERT) tokens
    text_len_t5: int = 256           # mT5 tokens
    dtype: torch.dtype = torch.bfloat16
    # the JAX model's sequence-parallel axis (ROADMAP M19) and ToMe ratio
    # (M18): not ported, a model with either set is refused
    sp_axis: Optional[str] = None
    tome_ratio: float = 0.0


def hunyuan_dit_config(**kw) -> HunyuanConfig:
    """Hunyuan-DiT v1.2's published transformer: 40 blocks of 1408, 16
    heads of 88."""
    return HunyuanConfig(**kw)


def silu_fp32(x: torch.Tensor) -> torch.Tensor:
    """SiLU in float32, cast back (JAX's `_silu_fp32`)."""
    return F.silu(x.float()).to(x.dtype)


def heads(t: torch.Tensor, n: int) -> torch.Tensor:
    """(B, N, n * d) -> contiguous (B, N, n, d)."""
    return t.reshape(t.shape[0], t.shape[1], n, -1).contiguous()


class HunyuanBlock(nn.Module):
    def __init__(self, cfg: HunyuanConfig, skip: bool = False):
        super().__init__()
        self.cfg = cfg
        c, d = cfg.hidden_size, cfg.hidden_size // cfg.num_heads
        if skip:
            self.skip_norm = LayerNorm(2 * c)
            self.skip_linear = Linear(2 * c, c)
        self.norm1 = LayerNorm(c)
        self.default_modulation_1 = Linear(c, c)
        self.attn1_qkv = Linear(c, 3 * c)
        self.attn1_q_norm = LayerNorm(d)
        self.attn1_k_norm = LayerNorm(d)
        self.attn1_proj = Linear(c, c)
        self.norm2 = LayerNorm(c)
        self.attn2_q = Linear(c, c)
        self.attn2_kv = Linear(cfg.clip_dim, 2 * c)
        self.attn2_q_norm = LayerNorm(d)
        self.attn2_k_norm = LayerNorm(d)
        self.attn2_proj = Linear(c, c)
        self.norm3 = LayerNorm(c)
        mlp = int(c * cfg.mlp_ratio)
        self.mlp_fc1 = Linear(c, mlp)
        self.mlp_fc2 = Linear(mlp, c)

    def forward(self, x, text, t_vec, freqs, skip_x=None):
        """x (B, N, hidden) tokens, text (B, M, clip_dim) the joint text
        stream, t_vec (B, hidden), freqs (N, d / 2, 2) float32, skip_x the
        matching first-half block's output (second-half blocks)."""
        cfg = self.cfg
        b, n, c = x.shape
        h = cfg.num_heads
        if skip_x is not None:
            x = self.skip_linear(self.skip_norm(torch.cat([x, skip_x], -1)))

        y = self.norm1(x) + self.default_modulation_1(F.silu(t_vec))[:, None]
        q, k, v = self.attn1_qkv(y).view(b, n, 3, h, c // h).unbind(2)
        q = apply_rope(self.attn1_q_norm(q), freqs)
        k = apply_rope(self.attn1_k_norm(k), freqs)
        a = attention(q, k, v.contiguous()).reshape(b, n, c)
        x = x + self.attn1_proj(a)

        q = self.attn2_q_norm(heads(self.attn2_q(self.norm2(x)), h))
        k, v = self.attn2_kv(text).view(b, text.shape[1], 2, h, c // h).unbind(2)
        a = attention(q, self.attn2_k_norm(k).contiguous(), v.contiguous())
        x = x + self.attn2_proj(a.reshape(b, n, c))

        return x + self.mlp_fc2(gelu_tanh(self.mlp_fc1(self.norm3(x))))


class AttentionPool(nn.Module):
    """diffusers' HunyuanDiTAttentionPool: the mean token prepended to the
    mT5 stream, a learned positional table added, one query (the mean
    token's) over all of them, `c_proj` to the pooled width."""

    def __init__(self, cfg: HunyuanConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.mt5_dim
        self.positional_embedding = nn.Parameter(
            torch.zeros(cfg.text_len_t5 + 1, w))
        self.q_proj = Linear(w, w)
        self.k_proj = Linear(w, w)
        self.v_proj = Linear(w, w)
        self.c_proj = Linear(w, cfg.pooled_dim)

    def forward(self, mt5: torch.Tensor) -> torch.Tensor:
        b, lm, w = mt5.shape
        hp = self.cfg.pooler_heads
        x = torch.cat([mt5.mean(dim=1, keepdim=True), mt5], dim=1)
        x = x + self.positional_embedding[:lm + 1].to(mt5.dtype)
        pooled = attention(heads(self.q_proj(x[:, :1]), hp),
                           heads(self.k_proj(x), hp), heads(self.v_proj(x), hp))
        return self.c_proj(pooled.reshape(b, w))


class HunyuanDiT(nn.Module):
    """forward(x (B, H, W, 4) NHWC latents, t (B,) DDPM timesteps, clip_text
    (B, 77, clip_dim), mt5_text (B, L, mt5_dim)) -> (B, H, W, 8) in the
    compute dtype."""

    def __init__(self, cfg: HunyuanConfig):
        super().__init__()
        if cfg.sp_axis is not None:
            raise NotImplementedError(
                "Hunyuan-DiT sp_axis (the sequence-parallel mesh, ROADMAP M19) "
                "is not ported")
        if cfg.tome_ratio > 0:
            raise NotImplementedError(
                "Hunyuan-DiT tome_ratio (ToMe, ROADMAP M18) is not ported")
        self.cfg = cfg
        c = cfg.hidden_size
        self.x_embedder = PatchEmbed(cfg.in_channels, c, cfg.patch_size)
        self.t_embedder = nn.ModuleDict({"mlp_0": Linear(256, c),
                                         "mlp_2": Linear(c, c)})
        self.pooler = AttentionPool(cfg)
        self.extra_embedder = nn.ModuleDict({"fc1": Linear(cfg.pooled_dim, 4 * c),
                                             "fc2": Linear(4 * c, c)})
        self.text_embedder = nn.ModuleDict({
            "linear_1": Linear(cfg.mt5_dim, 4 * cfg.mt5_dim),
            "linear_2": Linear(4 * cfg.mt5_dim, cfg.clip_dim)})
        # loaded for the checkpoint's sake and not used, as in JAX (diffusers
        # puts these rows in place of masked text tokens)
        self.text_embedding_padding = nn.Parameter(
            torch.zeros(cfg.text_len + cfg.text_len_t5, cfg.clip_dim))
        half = cfg.depth // 2
        self.blocks = nn.ModuleList(HunyuanBlock(cfg, skip=i >= half)
                                    for i in range(cfg.depth))
        self.final_adaLN_1 = Linear(c, 2 * c)
        self.final_linear = Linear(c, cfg.patch_size ** 2 * cfg.out_channels)
        self._freqs = {}

    def rope_table(self, hp: int, wp: int, device) -> torch.Tensor:
        """The 2-D RoPE table of the patch grid ((hp * wp, d / 2, 2) float32
        on `device`), memoized: the JAX module's table is a constant of its
        compiled program, and a host table rebuilt at every evaluation
        leaves the card idle (as PixArt.pos_table)."""
        key = (hp, wp, str(device))
        if key not in self._freqs:
            d = self.cfg.hidden_size // self.cfg.num_heads
            ys, xs = np.meshgrid(np.arange(hp), np.arange(wp), indexing="ij")
            ids = np.stack([ys, xs], -1).reshape(-1, 2)
            self._freqs[key] = torch.from_numpy(
                rope_freqs(ids, (d - d // 2, d // 2), 10000.0)).to(device)
        return self._freqs[key]

    def forward(self, x, t, clip_text, mt5_text, mode: str = "full"):
        check_full_mode(mode)
        cfg, dt = self.cfg, self.cfg.dtype
        p = cfg.patch_size
        b, hh, ww, _ = x.shape
        tokens = self.x_embedder(x.to(dt))
        freqs = self.rope_table(hh // p, ww // p, tokens.device)

        te = self.t_embedder
        t_vec = te["mlp_2"](F.silu(te["mlp_0"](timestep_embedding(t, 256).to(dt))))
        mt5 = mt5_text.to(dt)
        ee = self.extra_embedder
        t_vec = t_vec + ee["fc2"](silu_fp32(ee["fc1"](self.pooler(mt5))))
        tx = self.text_embedder
        text = torch.cat([clip_text.to(dt),
                          tx["linear_2"](silu_fp32(tx["linear_1"](mt5)))], dim=1)

        skips = []
        for i, blk in enumerate(self.blocks):
            if i < cfg.depth // 2:
                tokens = blk(tokens, text, t_vec, freqs)
                skips.append(tokens)
            else:
                tokens = blk(tokens, text, t_vec, freqs, skips.pop())

        scale, shift = self.final_adaLN_1(F.silu(t_vec)).chunk(2, dim=-1)
        out = no_affine_ln(tokens) * (1 + scale[:, None]) + shift[:, None]
        out = self.final_linear(out)
        return unpatchify(out, b, hh, ww, p, cfg.out_channels)
