"""FLUX.1 transformer (double-stream + single-stream DiT) in PyTorch — the
port of cremage_tpu/models/flux.py.

Packed 2x2x16 = 64-channel latent tokens, T5 context tokens, CLIP pooled
vector + timestep (+ guidance for -dev) modulation, 3-axis RoPE (axes
16/56/56 over head dim 128), RMS qk-norm, 19 double blocks (separate img
and txt streams, joint attention over [txt; img]) and 38 single blocks
(one stream, attention and MLP in parallel), velocity prediction.

Module names follow the BFL checkpoint keys (img_in, txt_in,
time_in.{in,out}_layer, vector_in, guidance_in, double_blocks.{i}.{img,txt}
_mod.lin / _attn.{qkv,proj,norm.{query,key}_norm.scale} / _mlp.{0,2},
single_blocks.{i}.{linear1,linear2,modulation.lin,norm.*}, final_layer.
{adaLN_modulation.1,linear}). Activations run in the compute dtype as in
JAX: RoPE and the norms in float32, then cast. Every attention call is
kernel K1 (dp = 128) on CUDA. The JAX model's ToMe, deep-cache and
sequence-parallel branches are not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cremage_tpu_torch.models.layers import Linear, timestep_embedding
from cremage_tpu_torch.ops.attention import attention


@dataclasses.dataclass(frozen=True)
class FluxConfig:
    in_channels: int = 64
    hidden_size: int = 3072
    num_heads: int = 24
    head_dim: int = 128
    depth_double: int = 19
    depth_single: int = 38
    mlp_ratio: int = 4
    context_dim: int = 4096
    vec_dim: int = 768
    axes_dim: Tuple[int, ...] = (16, 56, 56)
    theta: float = 10000.0
    guidance_embed: bool = False     # schnell: False, dev: True
    dtype: torch.dtype = torch.bfloat16


def flux_schnell_config(**kw) -> FluxConfig:
    return FluxConfig(guidance_embed=False, **kw)


def flux_dev_config(**kw) -> FluxConfig:
    return FluxConfig(guidance_embed=True, **kw)


def rope_freqs(ids: np.ndarray, axes_dim, theta: float) -> np.ndarray:
    """ids (N, n_axes) -> (N, head_dim / 2, 2) [cos, sin] table, float64 on
    the host, returned as float32."""
    outs = []
    for a, dim in enumerate(axes_dim):
        half = dim // 2
        freqs = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2 / dim))
        ang = np.asarray(ids[:, a], np.float64)[:, None] * freqs[None, :]
        outs.append(np.stack([np.cos(ang), np.sin(ang)], axis=-1))
    return np.concatenate(outs, axis=1).astype(np.float32)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """x (B, N, H, D), freqs (N, D / 2, 2): rotate pairs in float32, cast
    back to x's dtype."""
    b, n, h, d = x.shape
    xf = x.float().reshape(b, n, h, d // 2, 2)
    cos = freqs[None, :, None, :, 0]
    sin = freqs[None, :, None, :, 1]
    xr, xi = xf[..., 0], xf[..., 1]
    out = torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1)
    return out.reshape(b, n, h, d).to(x.dtype)


def make_position_ids(h_patches: int, w_patches: int, txt_len: int):
    txt_ids = np.zeros((txt_len, 3), np.int64)
    ys, xs = np.meshgrid(np.arange(h_patches), np.arange(w_patches),
                         indexing="ij")
    img_ids = np.stack([np.zeros_like(ys), ys, xs], axis=-1).reshape(-1, 3)
    return txt_ids, img_ids


def no_affine_ln(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=False)
    return ((x32 - mean) / torch.sqrt(var + eps)).to(x.dtype)


def modulate(x, shift, scale):
    """LayerNorm without affine, then x (1 + scale) + shift, per batch row."""
    return no_affine_ln(x) * (1 + scale[:, None]) + shift[:, None]


def gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


class RMSScale(nn.Module):
    """FLUX qk-norm: RMS norm in float32 (1 / sqrt, as JAX's `jax_rsqrt`)
    with a learned float32 `scale`."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * (1.0 / torch.sqrt((x32 * x32).mean(-1, keepdim=True) + 1e-6))
        return (x32 * self.scale).to(x.dtype)


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSScale(dim)
        self.key_norm = RMSScale(dim)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden: int):
        super().__init__()
        self.in_layer = Linear(in_dim, hidden)
        self.out_layer = Linear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Modulation(nn.Module):
    def __init__(self, hidden: int, n: int):
        super().__init__()
        self.n = n
        self.lin = Linear(hidden, n * hidden)

    def forward(self, vec):
        return self.lin(F.silu(vec)).chunk(self.n, dim=-1)


class SelfAttention(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.qkv = Linear(cfg.hidden_size, 3 * cfg.hidden_size)
        self.norm = QKNorm(cfg.head_dim)
        self.proj = Linear(cfg.hidden_size, cfg.hidden_size)


def joint_attention(q, k, v, freqs):
    """RoPE on q and k, then K1. v is made contiguous here: the kernel
    takes no strided view."""
    return attention(apply_rope(q, freqs), apply_rope(k, freqs),
                     v.contiguous())


class DoubleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        mlp = cfg.hidden_size * cfg.mlp_ratio
        for s in ("img", "txt"):
            setattr(self, f"{s}_mod", Modulation(cfg.hidden_size, 6))
            setattr(self, f"{s}_attn", SelfAttention(cfg))
            setattr(self, f"{s}_mlp", nn.ModuleDict({
                "0": Linear(cfg.hidden_size, mlp),
                "2": Linear(mlp, cfg.hidden_size)}))

    def _qkv(self, attn, x, shift, scale):
        cfg = self.cfg
        qkv = attn.qkv(modulate(x, shift, scale))
        b, n, _ = qkv.shape
        qkv = qkv.view(b, n, 3, cfg.num_heads, cfg.head_dim)
        return (attn.norm.query_norm(qkv[:, :, 0]),
                attn.norm.key_norm(qkv[:, :, 1]), qkv[:, :, 2])

    def forward(self, img, txt, vec, freqs):
        nt = txt.shape[1]
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(vec)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(vec)
        iq, ik, iv = self._qkv(self.img_attn, img, i_sh1, i_sc1)
        tq, tk, tv = self._qkv(self.txt_attn, txt, t_sh1, t_sc1)
        att = joint_attention(torch.cat([tq, iq], 1), torch.cat([tk, ik], 1),
                              torch.cat([tv, iv], 1), freqs)
        att = att.reshape(att.shape[0], att.shape[1], self.cfg.hidden_size)
        t_att, i_att = att[:, :nt], att[:, nt:]

        img = img + i_g1[:, None] * self.img_attn.proj(i_att)
        m = gelu_tanh(self.img_mlp["0"](modulate(img, i_sh2, i_sc2)))
        img = img + i_g2[:, None] * self.img_mlp["2"](m)

        txt = txt + t_g1[:, None] * self.txt_attn.proj(t_att)
        m = gelu_tanh(self.txt_mlp["0"](modulate(txt, t_sh2, t_sc2)))
        txt = txt + t_g2[:, None] * self.txt_mlp["2"](m)
        return img, txt


class SingleBlock(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.mlp_dim = h * cfg.mlp_ratio
        self.linear1 = Linear(h, 3 * h + self.mlp_dim)
        self.linear2 = Linear(h + self.mlp_dim, h)
        self.norm = QKNorm(cfg.head_dim)
        self.modulation = Modulation(h, 3)

    def forward(self, x, vec, freqs):
        cfg = self.cfg
        sh, sc, gate = self.modulation(vec)
        lin1 = self.linear1(modulate(x, sh, sc))
        qkv, mlp = lin1[..., :3 * cfg.hidden_size], lin1[..., 3 * cfg.hidden_size:]
        b, n, _ = qkv.shape
        qkv = qkv.reshape(b, n, 3, cfg.num_heads, cfg.head_dim)
        att = joint_attention(self.norm.query_norm(qkv[:, :, 0]),
                              self.norm.key_norm(qkv[:, :, 1]), qkv[:, :, 2],
                              freqs)
        out = self.linear2(torch.cat(
            [att.reshape(b, n, cfg.hidden_size), gelu_tanh(mlp)], dim=-1))
        return x + gate[:, None] * out


class FinalLayer(nn.Module):
    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.adaLN_modulation = nn.ModuleDict(
            {"1": Linear(cfg.hidden_size, 2 * cfg.hidden_size)})
        self.linear = Linear(cfg.hidden_size, cfg.in_channels)

    def forward(self, img, vec):
        sh, sc = self.adaLN_modulation["1"](F.silu(vec)).chunk(2, dim=-1)
        return self.linear(modulate(img, sh, sc))


class FluxModel(nn.Module):
    """forward(img_tokens (B, Ni, 64), txt_tokens (B, Nt, 4096), t (B,) in
    [0, 1], y_vec (B, 768), img_ids, txt_ids (host numpy), guidance (B,)
    for -dev) -> velocity (B, Ni, 64) in the compute dtype."""

    def __init__(self, cfg: FluxConfig):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.img_in = Linear(cfg.in_channels, h)
        self.txt_in = Linear(cfg.context_dim, h)
        self.time_in = MLPEmbedder(256, h)
        self.vector_in = MLPEmbedder(cfg.vec_dim, h)
        if cfg.guidance_embed:
            self.guidance_in = MLPEmbedder(256, h)
        self.double_blocks = nn.ModuleList(
            DoubleBlock(cfg) for _ in range(cfg.depth_double))
        self.single_blocks = nn.ModuleList(
            SingleBlock(cfg) for _ in range(cfg.depth_single))
        self.final_layer = FinalLayer(cfg)

    def freqs(self, img_ids, txt_ids, device) -> torch.Tensor:
        ids = np.concatenate([np.asarray(txt_ids), np.asarray(img_ids)], 0)
        return torch.from_numpy(rope_freqs(ids, self.cfg.axes_dim,
                                           self.cfg.theta)).to(device)

    def forward(self, img_tokens, txt_tokens, t, y_vec, img_ids, txt_ids,
                guidance: Optional[torch.Tensor] = None,
                freqs: Optional[torch.Tensor] = None):
        cfg, dt = self.cfg, self.cfg.dtype
        img = self.img_in(img_tokens.to(dt))
        txt = self.txt_in(txt_tokens.to(dt))
        vec = self.time_in(timestep_embedding(t.float() * 1000.0, 256).to(dt))
        if cfg.guidance_embed:
            if guidance is None:
                raise ValueError("FLUX-dev needs the guidance value")
            vec = vec + self.guidance_in(timestep_embedding(
                guidance.float() * 1000.0, 256).to(dt))
        vec = vec + self.vector_in(y_vec.to(dt))
        if freqs is None:
            freqs = self.freqs(img_ids, txt_ids, img.device)
        for blk in self.double_blocks:
            img, txt = blk(img, txt, vec, freqs)
        x = torch.cat([txt, img], dim=1)
        for blk in self.single_blocks:
            x = blk(x, vec, freqs)
        return self.final_layer(x[:, txt.shape[1]:], vec)


def pack_latents(lat: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 16) -> (B, H/2 * W/2, 64): 2x2 patches, (dy, dx, c) order
    as in JAX."""
    b, h, w, c = lat.shape
    lat = lat.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return lat.reshape(b, (h // 2) * (w // 2), 4 * c)


def unpack_latents(tokens: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H/2 * W/2, 64) -> (B, H, W, 16)."""
    b, c = tokens.shape[0], tokens.shape[-1] // 4
    lat = tokens.reshape(b, h // 2, w // 2, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return lat.reshape(b, h, w, c)
