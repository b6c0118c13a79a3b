"""PixArt-Σ txt2img pipeline — the port of cremage_tpu/pipelines/pixart.py.

Behavior contract (the JAX pipeline's):
- the caption is T5 over `t5_len` (120) tokens, or zeros of (t5_len,
  4096) without a T5 tower or tokenizer (the JAX loader gives none, so
  the served request conditions on zeros);
- eps prediction on the true-linear (0.0001, 0.02) DDPM table through the
  shared EpsDenoiser with CFG over the batched [uc; c], the learned-sigma
  half of the output dropped;
- the sampler is the menu's entry named by the job, "DPM++ 2M" for any
  name outside samplers/kdiffusion.py SAMPLER_SCHEDULE (the default
  "DDIM" among them), over the model's sigmas or Karras's by that table,
  without the churn options; the initial noise is the batch's
  `NoiseSource.initial` at (B, H/8, W/8, 4) times the first sigma, the
  samplers' draws its `step` draws;
- the statuses, the bf16 decode, the safety check, the watermark and the
  metadata as pipelines/sd3.py `dit_generate` gives them.

The speed features, the guidance interval and the meshes are refused as
in pipelines/sd3.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import NoiseSource, resolve_device
from cremage_tpu_torch.models.pixart import PixArt
from cremage_tpu_torch.models.t5 import T5Encoder
from cremage_tpu_torch.models.vae import AutoencoderKL
from cremage_tpu_torch.pipelines.sd3 import (
    NoiseFactory, NoMeshes, StatusCb, _noop_status, check_supported,
    dit_generate,
)
from cremage_tpu_torch.prompt.sentencepiece import as_t5_tokenize
from cremage_tpu_torch.samplers import kdiffusion as K
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import EpsDenoiser, cfg_denoiser
from cremage_tpu_torch.services.safety import ImageSafetyChecker, default_image_safety

DEFAULT_SAMPLER = "DPM++ 2M"


def pixart_schedule() -> S.DiscreteSchedule:
    """PixArt trains on the true-linear (0.0001, 0.02) DDPM table."""
    acp = S.alphas_cumprod_from_betas(S.make_betas_plain_linear())
    return S.DiscreteSchedule(S.sigmas_from_alphas_cumprod(acp))


def menu_sigmas(opts: GenerationOptions, sched: S.DiscreteSchedule,
                default: str):
    """-> (the job's menu sampler, `default` for a name outside
    samplers/kdiffusion.py SAMPLER_SCHEDULE; its sigmas over `sched`: the
    model's or Karras's, as that table says)."""
    name = opts.sampler if opts.sampler in K.SAMPLER_SCHEDULE else default
    steps = opts.sampling_steps
    if K.SAMPLER_SCHEDULE[name] == "model":
        return name, sched.get_sigmas(steps)
    return name, S.get_sigmas_karras(steps, sched.sigma_min, sched.sigma_max)


@dataclasses.dataclass
class PixArtBundle:
    dit: PixArt
    vae: AutoencoderKL
    t5: Optional[T5Encoder] = None
    t5_tokenize: Optional[Callable[[str], np.ndarray]] = None
    t5_len: int = 120
    schedule: S.DiscreteSchedule = dataclasses.field(
        default_factory=pixart_schedule)
    t5_dim: int = 4096
    load_report: Optional[Dict] = None


class PixArtPipeline(NoMeshes):
    """`safety`: the image safety checker of jobs with safety_check on (by
    default `default_image_safety`, built at the first such job)."""

    def __init__(self, bundle: PixArtBundle, device=None,
                 safety: Optional[ImageSafetyChecker] = None):
        bundle.t5_tokenize = as_t5_tokenize(bundle.t5_tokenize, bundle.t5_len)
        self.bundle = bundle
        self.device = resolve_device(device)
        self._safety = safety
        for m in (bundle.dit, bundle.vae, bundle.t5):
            if m is not None:
                m.to(self.device).eval()

    @property
    def safety(self) -> ImageSafetyChecker:
        if self._safety is None:
            self._safety = default_image_safety(device=self.device)
        return self._safety

    @torch.no_grad()
    def encode_text(self, prompt: str) -> torch.Tensor:
        """-> the (t5_len, 4096) float32 caption on the pipeline's device."""
        b = self.bundle
        if b.t5 is not None and b.t5_tokenize is not None:
            ids = np.asarray(b.t5_tokenize(prompt), np.int64)[: b.t5_len]
            ids = np.pad(ids, (0, b.t5_len - len(ids)))
            return b.t5(torch.from_numpy(ids[None]).to(self.device))[0].float()
        return torch.zeros(b.t5_len, b.t5_dim, device=self.device)

    def encode_pair(self, opts: GenerationOptions, batch: int):
        c, uc = (self.encode_text(p) for p in (opts.prompt, opts.negative_prompt))
        return (c[None].expand((batch,) + tuple(c.shape)),
                uc[None].expand((batch,) + tuple(uc.shape)))

    def sigmas(self, opts: GenerationOptions):
        """-> (sampler name, its sigmas)."""
        return menu_sigmas(opts, self.bundle.schedule, DEFAULT_SAMPLER)

    def denoiser(self, c, uc, scale: float):
        """The CFG denoiser over the DiT's eps, its learned-sigma half
        dropped."""
        dit = self.bundle.dit

        def eps_model(xx, tt, cond):
            return dit(xx, tt, cond)[..., :xx.shape[-1]]

        return cfg_denoiser(EpsDenoiser(eps_model, self.bundle.schedule), c,
                            uc, scale)

    def sample(self, opts: GenerationOptions, x: torch.Tensor, c, uc,
               status_cb: StatusCb = _noop_status,
               noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """The sampler from unit noise x (B, h, w, 4), scaled here by the
        first sigma -> float32 latents."""
        name, sigmas = self.sigmas(opts)
        den = self.denoiser(c, uc, float(opts.scale))
        steps = opts.sampling_steps
        return K.SAMPLERS[name](den, x * float(sigmas[0]), sigmas, noise,
                                progress_cb=lambda i: status_cb(
                                    f"{i + 1} / {steps}"))

    def generate(
        self,
        opts: GenerationOptions,
        status_cb: StatusCb = _noop_status,
        result_cb: Optional[Callable[[np.ndarray, Dict[str, Any]], None]] = None,
        noise: Optional[NoiseFactory] = None,
    ) -> List[Tuple[np.ndarray, Dict[str, Any]]]:
        """As pipelines/sd3.py SD3Pipeline.generate, with 4 latent
        channels."""
        check_supported(opts)
        return dit_generate(self, opts, status_cb, result_cb, noise, 4)
