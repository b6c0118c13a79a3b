"""OpenCLIP ViT image tower (ViT-H/14), SVD's image conditioner, in
PyTorch — the port of cremage_tpu/models/clip_vision.py.

Architecture contract (open_clip VisualTransformer, used by sgm
`FrozenOpenCLIPImageEmbedder`): the image normalized with the OpenAI mean
and standard deviation, a patch convolution without a bias, the class
token, a learned position embedding, ln_pre, the pre-LN transformer of
models/open_clip.py (its ResBlock; unmasked, so its attention runs through
kernel K1), ln_post on the class token and the projection. ViT-H/14: width
1280, 32 layers, 16 heads, patch 14, 224^2 input, projection to 1024.

Module names follow the checkpoint keys under
`conditioner.embedders.0.open_clip.model.visual.` with the fused attention
input projection split into q/k/v (io/checkpoint.py `split_svd`):
conv1.weight, class_embedding, positional_embedding, ln_pre,
transformer.resblocks.{i}.*, ln_post and proj (a bare (width, output_dim)
parameter used as x @ proj).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from cremage_tpu_torch.models.layers import Conv2d, LayerNorm
from cremage_tpu_torch.models.open_clip import OpenCLIPTextConfig, _Transformer

# CLIP image normalization (open_clip OPENAI_DATASET_MEAN / STD)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    width: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    output_dim: int = 1024
    dtype: torch.dtype = torch.bfloat16


def vit_h14_config(**kw) -> CLIPVisionConfig:
    return CLIPVisionConfig(**kw)


class CLIPVisionModel(nn.Module):
    """forward(images01 (B, S, S, 3) in [0, 1]) -> (B, output_dim) float32
    embedding. (JAX's `penultimate` output, which FaceID Plus reads, is not
    ported with it.)"""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        grid = cfg.image_size // cfg.patch_size
        self.conv1 = Conv2d(3, cfg.width, cfg.patch_size,
                            stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(cfg.width) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(grid * grid + 1, cfg.width) * 0.01)
        self.ln_pre = LayerNorm(cfg.width)
        self.transformer = _Transformer(OpenCLIPTextConfig(
            width=cfg.width, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, dtype=cfg.dtype))
        self.ln_post = LayerNorm(cfg.width)
        self.proj = nn.Parameter(torch.randn(cfg.width, cfg.output_dim) * 0.02)

    def forward(self, images01: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.cfg.dtype
        mean = torch.tensor(CLIP_MEAN, device=images01.device)
        std = torch.tensor(CLIP_STD, device=images01.device)
        x = (images01.float() - mean) / std
        x = self.conv1(x.permute(0, 3, 1, 2).to(dt))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)               # (B, grid^2, width)
        cls = self.class_embedding.to(dt).expand(b, 1, cfg.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dt)
        x = self.ln_pre(x).contiguous()
        for block in self.transformer.resblocks:
            x = block(x, None)
        pooled = self.ln_post(x[:, 0])
        return pooled.to(dt).float() @ self.proj.to(dt).float()
