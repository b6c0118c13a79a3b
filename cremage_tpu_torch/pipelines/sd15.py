"""SD1.5 txt2img pipeline (the port of the txt2img path of
cremage_tpu/pipelines/sd15.py).

Behavior contract: prompt weighting + chunking + filler-pad, clip_skip,
Euler A sampling with batched [uncond; cond] CFG, a batch loop with
per-image seed = seed + i, the VAE decode quantized to uint8 on the
device, `generation_parameters` metadata, and the "i / n" step statuses
and per-image result callback of the JAX pipeline.

The sampler state is NHWC float32 as in the JAX package; the UNet runs in
NCHW on the pipeline's device. Every unported option raises
NotImplementedError instead of being ignored.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.core.config import GenerationOptions, MODE_TEXT_TO_IMAGE
from cremage_tpu_torch.core.rng import (
    GeneratorNoise, NoiseSource, resolve_device, resolve_seed,
)
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.layers import set_compute_dtype
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel, sd15_unet_config
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig, decode_from_latent
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import EpsDenoiser, cfg_denoiser
from cremage_tpu_torch.samplers.kdiffusion import sample_euler_ancestral
from cremage_tpu_torch.utils.image import device_to_img01

logger = logging.getLogger(__name__)

StatusCb = Callable[[str], None]
NoiseFactory = Callable[[int, torch.device], NoiseSource]

SUPPORTED_SAMPLERS = ("Euler A",)


@dataclasses.dataclass
class SD15Bundle:
    """All loaded model state for one checkpoint."""

    unet: UNetModel
    text: TextEncoder
    vae: AutoencoderKL
    schedule: S.DiscreteSchedule


def _noop_status(msg: str) -> None:
    pass


def check_supported(opts: GenerationOptions) -> None:
    """Raise NotImplementedError for every option this port does not run
    yet (the JAX pipeline runs them all)."""
    unsupported = {
        "sampler": opts.sampler not in SUPPORTED_SAMPLERS,
        "mode": opts.mode != MODE_TEXT_TO_IMAGE,
        "use_hires_fix": bool(opts.use_hires_fix),
        "control_net": bool(opts.control_net),
        "face_input_img": bool(opts.face_input_img or opts.face_model),
        "safety_check": bool(opts.safety_check),
        "watermark": bool(opts.watermark),
        "auto_face_fix": bool(opts.auto_face_fix),
        "wildcards_path": bool(opts.wildcards_path),
        "lora_models": bool(opts.lora_models),
        "embedding_path": bool(opts.embedding_path),
        "deep_cache": int(opts.deep_cache) > 1,
        "tome_ratio": float(opts.tome_ratio) > 0.0,
        "ada_cache": float(opts.ada_cache) > 0.0,
        "cfg_interval": float(opts.cfg_interval_high) > float(opts.cfg_interval_low),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        vals = {k: getattr(opts, k, None) for k in bad}
        raise NotImplementedError(
            f"the PyTorch SD1.5 pipeline runs txt2img with the "
            f"{SUPPORTED_SAMPLERS} sampler only; not ported: {vals}")


class SD15Pipeline:
    def __init__(self, bundle: SD15Bundle, device=None):
        self.device = resolve_device(device)
        self.bundle = bundle
        for m in (bundle.unet, bundle.text.model, bundle.vae):
            m.to(self.device).eval()

    def _conditioning(self, opts: GenerationOptions, batch: int):
        c, uc = self.bundle.text.encode_pair(opts.prompt, opts.negative_prompt,
                                             opts.clip_skip)

        def tile(a):
            t = torch.as_tensor(a, dtype=torch.float32, device=self.device)
            return t[None].expand((batch,) + t.shape)
        return tile(c), tile(uc)

    def _eps_model(self, x, t, cond):
        """NHWC latents in, NHWC eps out; the UNet runs NCHW."""
        out = self.bundle.unet(x.permute(0, 3, 1, 2).contiguous(), t, cond)
        return out.permute(0, 2, 3, 1)

    def _sigma0(self, opts) -> float:
        """Initial-noise scale of Euler A: the schedule's first sampling
        sigma."""
        return float(self.bundle.schedule.get_sigmas(opts.sampling_steps)[0])

    def txt2img_latents(self, opts: GenerationOptions, c, uc,
                        noise: NoiseSource,
                        status_cb: StatusCb = _noop_status) -> torch.Tensor:
        """-> (B, H/f, W/f, 4) float32 latents."""
        h, w = opts.H // opts.f, opts.W // opts.f
        b = c.shape[0]
        x = noise.initial((b, h, w, self.bundle.unet.cfg.out_channels)) * \
            self._sigma0(opts)
        steps = opts.sampling_steps
        den = cfg_denoiser(EpsDenoiser(self._eps_model, self.bundle.schedule),
                           c, uc, float(opts.scale))
        return sample_euler_ancestral(
            den, x, self.bundle.schedule.get_sigmas(steps), noise,
            progress_cb=lambda i: status_cb(f"{i + 1} / {steps}"))

    def generate(
        self,
        opts: GenerationOptions,
        status_cb: StatusCb = _noop_status,
        result_cb: Optional[Callable[[np.ndarray, Dict[str, Any]], None]] = None,
        noise: Optional[NoiseFactory] = None,
    ) -> List[Tuple[np.ndarray, Dict[str, Any]]]:
        """Run the job: n_iter batches x n_samples images.

        Returns [(image_01 (H, W, 3) float, generation_parameters dict)].
        `noise(seed, device)` builds the noise source of the batch whose
        first image has `seed`; by default a torch.Generator seeded with it.
        """
        check_supported(opts)
        noise = noise or GeneratorNoise
        base_seed = resolve_seed(opts.seed)
        results = []
        img_index = 0
        with torch.no_grad():
            for it in range(opts.n_iter):
                b = opts.n_samples
                status_cb(f"batch {it + 1}/{opts.n_iter}: encoding prompt")
                c, uc = self._conditioning(opts, b)
                t0 = time.perf_counter()
                lat = self.txt2img_latents(
                    opts, c, uc, noise(base_seed + img_index, self.device),
                    status_cb)
                status_cb("decoding")
                imgs = decode_from_latent(self.bundle.vae,
                                          lat.to(torch.bfloat16))
                imgs = device_to_img01(imgs)
                logger.info("sampling+decode took %.2fs",
                            time.perf_counter() - t0)
                for i in range(b):
                    meta = dataclasses.asdict(opts)
                    meta["seed"] = base_seed + img_index
                    meta.pop("extra", None)
                    results.append((imgs[i], meta))
                    if result_cb is not None:
                        result_cb(imgs[i], meta)
                    img_index += 1
        return results


def build_sd15_bundle(device=None, dtype: torch.dtype = torch.bfloat16,
                      seed: int = 0,
                      unet_cfg: Optional[UNetConfig] = None,
                      vae_cfg: Optional[VAEConfig] = None,
                      clip_cfg: Optional[CLIPTextConfig] = None) -> SD15Bundle:
    """An SD1.5 bundle with seeded random weights, built on `device` in
    `dtype` (default: the full SD1.5 configs). The port has no checkpoint
    loader yet."""
    device = resolve_device(device)
    unet_cfg = unet_cfg or sd15_unet_config(dtype=dtype)
    vae_cfg = vae_cfg or VAEConfig(dtype=dtype)
    clip_cfg = clip_cfg or CLIPTextConfig(dtype=dtype)
    fork = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=fork), torch.device(device):
        torch.manual_seed(seed)
        unet = set_compute_dtype(UNetModel(unet_cfg), unet_cfg.dtype)
        vae = set_compute_dtype(AutoencoderKL(vae_cfg), vae_cfg.dtype)
        clip = set_compute_dtype(CLIPTextModel(clip_cfg), clip_cfg.dtype)
    return SD15Bundle(unet=unet.eval(), vae=vae.eval(),
                      text=TextEncoder(clip.eval(), default_tokenizer()),
                      schedule=S.default_sd_schedule())
