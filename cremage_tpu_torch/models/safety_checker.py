"""CompVis Stable Diffusion image safety checker (the port of
cremage_tpu/models/safety_checker.py).

Behavior contract: reference `modules/safety/safety_filter.py:19-151`, the
diffusers StableDiffusionSafetyChecker: an HF CLIP ViT-L/14 vision tower
(14x14 patch conv, class token, positions, `pre_layrnorm`, 24 CLIP layers,
`post_layernorm` on the class token) and a visual projection; the cosine
similarities of the projected embedding with 17 concept and 3 special-care
embeddings, less their thresholds, are the scores; any special-care hit
adds 0.01 to the concept scores; an image with a concept score > 0 is
flagged. The tower's layers are the port's `CLIPLayer` without a mask, so
their attention runs in kernel K1 (16 heads of d = 64 over 257 tokens)
on the card. Module names follow the checkpoint's HF keys
(vision_model.vision_model.*, visual_projection.weight, concept_embeds,
special_care_embeds and their `_weights`).

`preprocess_images01` is the HF CLIPFeatureExtractor step of the JAX
package, which calls cv2.resize(INTER_CUBIC): here the bicubic resize is a
pair of weight matrices (`cubic_resize_matrix`, OpenCV's kernel: a = -0.75,
half-pixel centres, replicated border, no antialiasing when shrinking)
applied on the device.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from cremage_tpu_torch.io.checkpoint import POSITION_IDS, load_into, load_state_dict
from cremage_tpu_torch.models.clip import CLIPTextConfig, _Encoder
from cremage_tpu_torch.models.layers import Conv2d, LayerNorm, Linear, set_compute_dtype

# HF CLIPFeatureExtractor normalization
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
CUBIC_A = -0.75      # OpenCV's bicubic kernel parameter


@dataclasses.dataclass(frozen=True)
class SafetyCheckerConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    n_concepts: int = 17
    n_special: int = 3
    dtype: torch.dtype = torch.bfloat16


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.patch_embedding = Conv2d(3, cfg.hidden_size, cfg.patch_size,
                                      stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.randn(cfg.hidden_size) * 0.02)
        self.position_embedding = nn.Embedding(n_pos, cfg.hidden_size)
        nn.init.normal_(self.position_embedding.weight, std=0.02)


class CLIPVisionTower(nn.Module):
    """HF CLIPVisionModel's `vision_model`: pixels -> the pooled class
    token after post_layernorm."""

    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        self.cfg = cfg
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = LayerNorm(cfg.hidden_size)     # (sic) HF's name
        self.encoder = _Encoder(CLIPTextConfig(
            hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
            num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
            dtype=cfg.dtype))
        self.post_layernorm = LayerNorm(cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """pixel_values: (B, S, S, 3) normalized, NHWC as the JAX module."""
        dtype = self.cfg.dtype
        emb = self.embeddings
        x = emb.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(dtype))
        b, c = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)                  # (B, tokens, C)
        cls = emb.class_embedding.to(dtype).expand(b, 1, c)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight.to(dtype)
        x = self.pre_layrnorm(x.contiguous())
        for layer in self.encoder.layers:
            x = layer(x, None)
        return self.post_layernorm(x[:, 0])


class _VisionModel(nn.Module):
    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        self.vision_model = CLIPVisionTower(cfg)


class StableDiffusionSafetyChecker(nn.Module):
    """pixel_values (B, S, S, 3) pre-normalized -> (concept scores (B, 17),
    special scores (B, 3)) in float32; a score > 0 is a hit."""

    def __init__(self, cfg: SafetyCheckerConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = _VisionModel(cfg)
        self.visual_projection = Linear(cfg.hidden_size, cfg.projection_dim,
                                        bias=False)
        self.concept_embeds = nn.Parameter(
            torch.randn(cfg.n_concepts, cfg.projection_dim))
        self.special_care_embeds = nn.Parameter(
            torch.randn(cfg.n_special, cfg.projection_dim))
        self.concept_embeds_weights = nn.Parameter(torch.ones(cfg.n_concepts))
        self.special_care_embeds_weights = nn.Parameter(
            torch.ones(cfg.n_special))

    def forward(self, pixel_values):
        pooled = self.vision_model.vision_model(pixel_values)
        emb = self.visual_projection(pooled).float()

        def cos(a, b):
            a = a / torch.linalg.norm(a, dim=-1, keepdim=True)
            b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
            return a @ b.T

        special = cos(emb, self.special_care_embeds.float()) \
            - self.special_care_embeds_weights.float()[None]
        # diffusers: any special-care hit adds 0.01 to the concept scores
        adjust = (special > 0).any(dim=-1, keepdim=True).float() * 0.01
        concept = cos(emb, self.concept_embeds.float()) \
            - self.concept_embeds_weights.float()[None] + adjust
        return concept, special


def cubic_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of OpenCV's INTER_CUBIC along one axis:
    source x = (i + 0.5) * n_in / n_out - 0.5 (half-pixel centres), taps
    floor(x) - 1 .. floor(x) + 2 clamped to the edge (replicated border),
    Keys' kernel with a = -0.75; no antialiasing when shrinking."""
    scale = 1.0 / (n_out / n_in)
    a = CUBIC_A
    w = np.zeros((n_out, n_in))
    for i in range(n_out):
        fx = (i + 0.5) * scale - 0.5
        sx = math.floor(fx)
        t = fx - sx
        c0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
        c1 = ((a + 2) * t - (a + 3)) * t * t + 1
        c2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
        for k, c in enumerate((c0, c1, c2, 1.0 - c0 - c1 - c2)):
            w[i, min(max(sx - 1 + k, 0), n_in - 1)] += c
    return w


def preprocess_images01(images01, size: int = 224,
                        device=None) -> torch.Tensor:
    """HF CLIPFeatureExtractor on (B, H, W, 3) or (H, W, 3) float images in
    [0, 1]: shortest edge bicubic-resized to `size`, centre crop,
    normalize. -> (B, size, size, 3) float32 on `device` (the images'
    device by default)."""
    x = torch.as_tensor(np.asarray(images01, np.float32)
                        if not isinstance(images01, torch.Tensor) else images01)
    if x.ndim == 3:
        x = x[None]
    device = device if device is not None else x.device
    x = x.to(device, torch.float32)
    h, w = x.shape[1:3]
    scale = size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    top, left = (nh - size) // 2, (nw - size) // 2
    wy = torch.as_tensor(cubic_resize_matrix(h, nh)[top:top + size],
                         dtype=torch.float32, device=device)
    wx = torch.as_tensor(cubic_resize_matrix(w, nw)[left:left + size],
                         dtype=torch.float32, device=device)
    r = torch.einsum("yh,bhwc->bywc", wy, x)
    r = torch.einsum("xw,bywc->byxc", wx, r)
    mean = torch.tensor(CLIP_MEAN, device=device)
    std = torch.tensor(CLIP_STD, device=device)
    return (r - mean) / std


def build_safety_checker(sd, cfg: Optional[SafetyCheckerConfig] = None,
                         device=None) -> StableDiffusionSafetyChecker:
    """The checker loaded from a state dict under HF names (strict; the
    tower's position_ids buffer is dropped by name)."""
    cfg = cfg or SafetyCheckerConfig()
    sd = {k: v for k, v in sd.items()
          if k != "vision_model.vision_model." + POSITION_IDS}
    with torch.device("meta"):
        model = set_compute_dtype(StableDiffusionSafetyChecker(cfg), cfg.dtype)
    return load_into(model, sd, device, "safety checker").eval()


def load_safety_classifier(weights_path: str,
                           cfg: Optional[SafetyCheckerConfig] = None,
                           device=None) -> Callable[[np.ndarray], np.ndarray]:
    """-> classifier(images01 (B, H, W, 3)) -> (B,) scores in {0, 1} for
    services/safety.py ImageSafetyChecker (threshold 0.5)."""
    from cremage_tpu_torch.core.rng import resolve_device

    device = resolve_device(device)
    t0 = time.perf_counter()
    sd = load_state_dict(weights_path)
    model = build_safety_checker(sd, cfg, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    def classifier(images01: np.ndarray) -> np.ndarray:
        x = preprocess_images01(images01, model.cfg.image_size, device)
        with torch.no_grad():
            concept, _ = model(x)
        return (concept > 0).any(-1).float().cpu().numpy()

    classifier.model = model
    classifier.load_report = {weights_path: dict(
        bytes=sum(t.numel() * t.element_size() for t in sd.values()),
        seconds=time.perf_counter() - t0)}
    return classifier
