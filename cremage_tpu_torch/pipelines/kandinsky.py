"""Kandinsky 2.2 pipeline (prior -> decoder -> MoVQ) — the port of
cremage_tpu/pipelines/kandinsky.py.

Behavior contract (the JAX pipeline's, with the bundle its loader builds):
- the text: the HF bigG tower's final-LayerNorm states over the prompt's
  77 ids (BOS, ids, EOS, EOS padding; no weighting) and its projected
  pooled output at the first EOS;
- per batch, the statuses "prior", "decoder" and "i / n" after each
  decoder step;
- the prior: eps on the squaredcos_cap_v2 DDPM table, CFG over the
  batched [uc; c] (the negative prompt's text), 25 Euler A steps from the
  batch's `NoiseSource.prior()` (its initial noise at (1, image_embed_dim)
  times the first sigma), its output unnormalised as emb * clip_std +
  clip_mean; the negative image embedding is clip_mean (zeros without the
  statistics);
- the decoder: the image conditioner's time vector and 10 context tokens
  of [negative; image embedding], eps on the same table with CFG, the
  first 4 of the UNet's 8 output channels; the sampler is the menu's entry
  named by the job, "Euler A" for any name outside samplers/kdiffusion.py
  SAMPLER_SCHEDULE (the options' default "DDIM" among them), over the
  model's sigmas or Karras's by that table, from the batch's `initial`
  noise at (B, H/8, W/8, 4) times the first sigma;
- MoVQ decodes the float32 latent rounded to the compute dtype; pixels go
  to uint8 on the device;
- inpainting composites after the decode: the decoded pixels where the
  mask is >= 0.5, the init image's elsewhere;
- the image safety check, the watermark, seed = seed + i.

img2img with an init image raises JAX's RuntimeError (the served bundle
has no latent encoder); the port raises it before the prior runs, JAX
after. The speed features, the guidance interval and the pipeline-parallel
mesh are refused as in pipelines/sd3.py.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.core.config import (
    GenerationOptions, MODE_IMAGE_TO_IMAGE, MODE_INPAINTING,
)
from cremage_tpu_torch.core.rng import (
    GeneratorNoise, NoiseSource, resolve_device, resolve_seed,
)
from cremage_tpu_torch.models.kandinsky import DiffusionPrior, KandinskyImageConditioner
from cremage_tpu_torch.models.kandinsky_decoder import (
    KandinskyUNet, kandinsky_decoder_eps,
)
from cremage_tpu_torch.models.open_clip import OpenCLIPTextModel
from cremage_tpu_torch.models.vq import MoVQ
from cremage_tpu_torch.pipelines.pixart import menu_sigmas
from cremage_tpu_torch.pipelines.sd3 import (
    NoiseFactory, NoMeshes, StatusCb, _noop_status, check_supported,
)
from cremage_tpu_torch.prompt.tokenizer import CLIPTokenizer, default_tokenizer
from cremage_tpu_torch.samplers import kdiffusion as K
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import EpsDenoiser, cfg_denoiser
from cremage_tpu_torch.services.safety import ImageSafetyChecker, default_image_safety
from cremage_tpu_torch.services.watermark import embed_watermark
from cremage_tpu_torch.utils.image import device_to_img01

DEFAULT_SAMPLER = "Euler A"
IMG2IMG_REFUSAL = ("Kandinsky img2img needs a latent encoder: load the MoVQ "
                   "checkpoint with its encoder, or supply a KL vae stand-in")


def kandinsky_schedule() -> S.DiscreteSchedule:
    """The prior's and the decoder's squaredcos_cap_v2 DDPM table."""
    acp = S.alphas_cumprod_from_betas(S.make_betas_squaredcos())
    return S.DiscreteSchedule(S.sigmas_from_alphas_cumprod(acp))


class KandinskyTextEncoder:
    """`encode(prompt, device)` -> (the final-LayerNorm states (max_positions,
    width), the projected pooled output at the first EOS (width,)), float32
    (JAX's `load_hf_clip_text_tower` text_encode)."""

    def __init__(self, tower: OpenCLIPTextModel,
                 tokenizer: Optional[CLIPTokenizer] = None):
        self.tower = tower
        self.tokenizer = tokenizer or default_tokenizer()

    @torch.no_grad()
    def encode(self, prompt: str, device) -> Tuple[torch.Tensor, torch.Tensor]:
        n = self.tower.cfg.max_positions
        ids = self.tokenizer.encode_with_specials(prompt, max_len=n)
        eos = min(len(self.tokenizer.encode(prompt)), n - 2) + 1
        x = self.tower.embed_tokens(torch.tensor([ids], device=device))
        _, final = self.tower(x)
        pooled = self.tower.project_pooled(final, torch.tensor([eos]))
        return final[0].float(), pooled[0].float()


@dataclasses.dataclass
class KandinskyBundle:
    prior: DiffusionPrior
    decoder: KandinskyUNet
    image_cond: KandinskyImageConditioner
    movq: MoVQ
    text: KandinskyTextEncoder
    clip_mean: Optional[torch.Tensor] = None     # (image_embed_dim,) float32
    clip_std: Optional[torch.Tensor] = None
    schedule: S.DiscreteSchedule = dataclasses.field(
        default_factory=kandinsky_schedule)
    prior_steps: int = 25
    load_report: Optional[Dict] = None


class KandinskyPipeline(NoMeshes):
    """`safety`: the image safety checker of jobs with safety_check on (by
    default `default_image_safety`, built at the first such job)."""

    def __init__(self, bundle: KandinskyBundle, device=None,
                 safety: Optional[ImageSafetyChecker] = None):
        self.bundle = bundle
        self.device = resolve_device(device)
        self._safety = safety
        for m in (bundle.prior, bundle.decoder, bundle.image_cond, bundle.movq,
                  bundle.text.tower):
            m.to(self.device).eval()
        for name in ("clip_mean", "clip_std"):
            t = getattr(bundle, name)
            if t is not None:
                setattr(bundle, name, t.float().to(self.device))

    @property
    def safety(self) -> ImageSafetyChecker:
        if self._safety is None:
            self._safety = default_image_safety(device=self.device)
        return self._safety

    @torch.no_grad()
    def run_prior(self, prompt: str, negative_prompt: str, scale: float,
                  noise: NoiseSource) -> Tuple[torch.Tensor, torch.Tensor]:
        """-> (the image embedding, the negative one), float32 (E,)."""
        b, dev = self.bundle, self.device
        cond = tuple(t[None] for t in b.text.encode(prompt, dev))
        uncond = tuple(t[None] for t in b.text.encode(negative_prompt, dev))
        sigmas = b.schedule.get_sigmas(b.prior_steps)

        def eps_model(x, t, c):
            return b.prior(x, t, *c)

        den = cfg_denoiser(EpsDenoiser(eps_model, b.schedule), cond, uncond,
                           float(scale))
        dim = b.prior.cfg.image_embed_dim
        x = noise.initial((1, dim)) * float(sigmas[0])
        emb = K.sample_euler_ancestral(den, x, sigmas, noise)[0].float()
        neg = torch.zeros(dim, device=dev)
        if b.clip_mean is not None:
            emb = emb * b.clip_std.reshape(-1) + b.clip_mean.reshape(-1)
            neg = b.clip_mean.reshape(-1).clone()
        return emb, neg

    def sigmas(self, opts: GenerationOptions):
        """-> (sampler name, its sigmas)."""
        return menu_sigmas(opts, self.bundle.schedule, DEFAULT_SAMPLER)

    def denoiser(self, emb, neg, scale: float):
        """The CFG denoiser over the decoder's eps, conditioned on the
        image embeddings (B, E) through the image conditioner."""
        b = self.bundle

        def eps_model(xx, tt, cond):
            tvec, ctx = b.image_cond(cond)
            return kandinsky_decoder_eps(b.decoder(xx, tt, ctx, tvec))

        return cfg_denoiser(EpsDenoiser(eps_model, b.schedule), emb, neg, scale)

    @torch.no_grad()
    def generate(
        self,
        opts: GenerationOptions,
        status_cb: StatusCb = _noop_status,
        result_cb: Optional[Callable[[np.ndarray, Dict[str, Any]], None]] = None,
        init_image: Optional[np.ndarray] = None,
        mask_image: Optional[np.ndarray] = None,
        noise: Optional[NoiseFactory] = None,
    ) -> List[Tuple[np.ndarray, Dict[str, Any]]]:
        """n_iter batches x n_samples images. Returns [(image_01 (H, W, 3)
        float, metadata)]. `init_image` (H, W, 3) in [-1, 1] and
        `mask_image` (H, W) in [0, 1] (1 = repaint) serve mode inpainting;
        `noise(seed, device)` builds the noise source of the batch whose
        first image has `seed`."""
        check_supported(opts)
        if opts.mode == MODE_IMAGE_TO_IMAGE and init_image is not None:
            raise RuntimeError(IMG2IMG_REFUSAL)
        noise = noise or GeneratorNoise
        base_seed = resolve_seed(opts.seed)
        results = []
        img_index = 0
        for _ in range(opts.n_iter):
            bsz = opts.n_samples
            src = noise(base_seed + img_index, self.device)
            status_cb("prior")
            emb, neg = self.run_prior(opts.prompt, opts.negative_prompt,
                                      opts.scale, src.prior())
            status_cb("decoder")
            name, sigmas = self.sigmas(opts)
            den = self.denoiser(emb[None].expand(bsz, -1),
                                neg[None].expand(bsz, -1), float(opts.scale))
            x = src.initial((bsz, opts.H // 8, opts.W // 8, 4)) * float(sigmas[0])
            steps = opts.sampling_steps
            lat = K.SAMPLERS[name](den, x, sigmas, src, progress_cb=lambda i:
                                   status_cb(f"{i + 1} / {steps}"))
            imgs = device_to_img01(self.bundle.movq.decode(lat))
            if opts.mode == MODE_INPAINTING and mask_image is not None \
                    and init_image is not None:
                m = (np.asarray(mask_image) >= 0.5).astype(np.float32)[..., None]
                init01 = (np.asarray(init_image, np.float32) + 1) / 2
                imgs = imgs * m[None] + init01[None] * (1 - m[None])
            if opts.safety_check:
                imgs, _ = self.safety.check(imgs)
            for i in range(bsz):
                img = embed_watermark(imgs[i]) if opts.watermark else imgs[i]
                meta = dataclasses.asdict(opts)
                meta["seed"] = base_seed + img_index
                meta.pop("extra", None)
                results.append((img, meta))
                if result_cb is not None:
                    result_cb(img, meta)
                img_index += 1
        return results
