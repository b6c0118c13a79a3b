"""SD1.5 pipeline: txt2img, img2img and inpainting, with hires fix (the
port of cremage_tpu/pipelines/sd15.py).

Behavior contract: prompt weighting + chunking + filler-pad, clip_skip,
the reference's 12-name sampler menu (DDIM + the 11 k-diffusion names of
samplers/kdiffusion.py) and the JAX server's `extra_samplers` (PLMS, DPM
Solver, LCM) with batched [uncond; cond] CFG, img2img from the
VAE encoder's posterior sample with t_enc = max(1, int(strength * steps)),
inpainting through the 9-channel UNet with [x, mask, masked-image latent]
conditioning and the result composited over the unmasked pixels, hires fix
("Latent" nearest or "Lanczos" pixel upscale, then img2img at the new
size), a ControlNet's residuals in txt2img (the control image in [0, 1],
NHWC, tiled over the CFG batch, scaled by control_weight), wildcards
re-resolved per batch, a batch loop with per-image seed = seed + i, the VAE
decode quantized to uint8 on the device, the image safety check (flagged
images replaced; each image's flag in its metadata as "nsfw"), the
watermark, `generation_parameters` metadata, and the "i / n" step statuses
and per-image result callback of the JAX pipeline.

The sampler state is NHWC float32 as in the JAX package; the UNet runs in
NCHW on the pipeline's device. Every random number comes from the batch's
`NoiseSource` (core/rng.py). Every unported option raises
NotImplementedError instead of being ignored.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.core.config import (
    GenerationOptions, MODE_IMAGE_TO_IMAGE, MODE_INPAINTING, MODE_TEXT_TO_IMAGE,
)
from cremage_tpu_torch.core.rng import (
    GeneratorNoise, NoiseSource, resolve_device, resolve_seed,
)
from cremage_tpu_torch.io.quantize import unet_kind
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.controlnet import ControlNet
from cremage_tpu_torch.models.layers import set_compute_dtype
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel, sd15_unet_config
from cremage_tpu_torch.models.vae import (
    AutoencoderKL, VAEConfig, decode_from_latent, encode_to_latent,
)
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.prompt.wildcards import resolve_wildcards
from cremage_tpu_torch.samplers import ddim as DDIM
from cremage_tpu_torch.samplers import kdiffusion as K
from cremage_tpu_torch.samplers import lcm as LCM
from cremage_tpu_torch.samplers import ldm_extra as LDMX
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import EpsDenoiser, cfg_denoiser
from cremage_tpu_torch.services.safety import ImageSafetyChecker, default_image_safety
from cremage_tpu_torch.services.watermark import embed_watermark
from cremage_tpu_torch.utils.image import device_to_img01
from cremage_tpu_torch.utils.resize import resize

logger = logging.getLogger(__name__)

StatusCb = Callable[[str], None]
NoiseFactory = Callable[[int, torch.device], NoiseSource]

# the reference's menu, as the JAX server's /v1/meta lists it, and the
# samplers beyond it that the JAX server lists as `extra_samplers`
SAMPLER_MENU = ("DDIM",) + tuple(sorted(K.SAMPLER_SCHEDULE))
EXTRA_SAMPLERS = ("PLMS", "DPM Solver", "LCM")
# driven by the DDPM timestep t, from unit noise (LCM from its grid's top
# sigma), not by the k-diffusion sigma schedule
T_DRIVEN_SAMPLERS = ("DDIM", "PLMS", "DPM Solver", "LCM")
MODES = (MODE_TEXT_TO_IMAGE, MODE_IMAGE_TO_IMAGE, MODE_INPAINTING)


@dataclasses.dataclass
class SD15Bundle:
    """All loaded model state for one checkpoint."""

    unet: UNetModel
    text: TextEncoder
    vae: AutoencoderKL
    schedule: S.DiscreteSchedule
    controlnet: Optional[ControlNet] = None
    # pipelines/loader.py: the files' bytes and load seconds, the LoRA merge
    load_report: Optional[Dict[str, Any]] = None

    @property
    def inpaint(self) -> bool:
        """Whether the UNet is the 9-channel inpainting one."""
        return self.unet.cfg.in_channels == 9


def _noop_status(msg: str) -> None:
    pass


def check_supported(opts: GenerationOptions) -> None:
    """Raise NotImplementedError for every option this port does not run
    yet (the JAX pipeline runs them all), int8 UNet storage among them
    (io/quantize.py `unet_kind`)."""
    unet_kind(opts.extra.get("unet_quantize"))
    unsupported = {
        "sampler": opts.sampler not in SAMPLER_MENU + EXTRA_SAMPLERS,
        "mode": opts.mode not in MODES,
        "face_input_img": bool(opts.face_input_img or opts.face_model),
        "auto_face_fix": bool(opts.auto_face_fix),
        "deep_cache": int(opts.deep_cache) > 1,
        "tome_ratio": float(opts.tome_ratio) > 0.0,
        "ada_cache": float(opts.ada_cache) > 0.0,
        "cfg_interval": float(opts.cfg_interval_high) > float(opts.cfg_interval_low),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        vals = {k: getattr(opts, k, None) for k in bad}
        raise NotImplementedError(
            f"the PyTorch SD1.5 pipeline runs the modes {MODES} with the "
            f"samplers {SAMPLER_MENU + EXTRA_SAMPLERS}; not ported: {vals}")


class SD15Pipeline:
    """`safety`: the image safety checker of jobs with safety_check on; by
    default `default_image_safety` (the CompVis checker on
    $SAFETY_CHECKER_PATH's weights, else a pass-through), built at the
    first such job."""

    def __init__(self, bundle: SD15Bundle, device=None,
                 safety: Optional[ImageSafetyChecker] = None):
        self.device = resolve_device(device)
        self.bundle = bundle
        self._safety = safety
        for m in (bundle.unet, bundle.text.model, bundle.vae,
                  bundle.controlnet):
            if m is not None:
                m.to(self.device).eval()

    @property
    def safety(self) -> ImageSafetyChecker:
        if self._safety is None:
            self._safety = default_image_safety(device=self.device)
        return self._safety

    def _conditioning(self, opts: GenerationOptions, batch: int):
        c, uc = self.bundle.text.encode_pair(opts.prompt, opts.negative_prompt,
                                             opts.clip_skip)

        def tile(a):
            t = torch.as_tensor(a, dtype=torch.float32, device=self.device)
            return t[None].expand((batch,) + t.shape)
        return tile(c), tile(uc)

    def _eps_model(self, extra: Optional[torch.Tensor] = None,
                   hint: Optional[torch.Tensor] = None,
                   control_weight: float = 1.0):
        """eps(x, t, cond): NHWC latents in, NHWC eps out; the UNet runs
        NCHW. `extra` (the inpainting channels) is tiled over the CFG
        batch and appended after x's channels, as the JAX package
        concatenates them channel-last. With `hint` (NCHW, the bundle's
        ControlNet present) the ControlNet runs on x and the hint tiled
        over the CFG batch, and its residuals, times control_weight, go
        into the UNet."""
        unet = self.bundle.unet
        cn = self.bundle.controlnet if hint is not None else None

        def eps(x, t, cond):
            control = None
            if cn is not None:
                h = hint.repeat(x.shape[0] // hint.shape[0], 1, 1, 1)
                res_in, res_mid = cn(x.permute(0, 3, 1, 2).contiguous(), h,
                                     t, cond)
                if control_weight != 1.0:    # x * 1.0 is exact: skipped
                    res_in = [r * control_weight for r in res_in]
                    res_mid = res_mid * control_weight
                control = (res_in, res_mid)
            if extra is not None:
                ec = extra.repeat(x.shape[0] // extra.shape[0], 1, 1, 1)
                x = torch.cat([x, ec.to(x.dtype)], dim=-1)
            return unet(x.permute(0, 3, 1, 2).contiguous(), t, cond,
                        control).permute(0, 2, 3, 1)
        return eps

    def _sigma0(self, opts) -> float:
        """Initial-noise scale: k-diffusion's x = N(0, 1) * sigma_max of
        the sampler's schedule; the t-driven samplers start from unit
        noise, LCM at its own grid's top sigma."""
        if opts.sampler == "LCM":
            return float(LCM.make_lcm_schedule(
                self.bundle.schedule.alphas_cumprod,
                opts.sampling_steps).sigmas[0])
        if opts.sampler in T_DRIVEN_SAMPLERS:
            return 1.0
        if K.SAMPLER_SCHEDULE[opts.sampler] == "model":
            return float(self.bundle.schedule.get_sigmas(opts.sampling_steps)[0])
        return self.bundle.schedule.sigma_max

    def _sample(self, opts: GenerationOptions, x_init: Optional[torch.Tensor],
                c, uc, noise: NoiseSource, steps: int,
                t_enc: Optional[int] = None,
                init_latent: Optional[torch.Tensor] = None,
                extra: Optional[torch.Tensor] = None,
                status_cb: StatusCb = _noop_status,
                hint: Optional[torch.Tensor] = None,
                control_weight: float = 1.0) -> torch.Tensor:
        """Run the selected sampler; with t_enc, partial denoising from
        init_latent after a stochastic encode (img2img)."""
        name, scale = opts.sampler, float(opts.scale)
        total = t_enc if t_enc is not None else steps

        def progress(i):
            status_cb(f"{i + 1} / {total}")

        sched = self.bundle.schedule
        eps_model = self._eps_model(extra, hint, control_weight)
        if name in T_DRIVEN_SAMPLERS:
            return self._sample_t_driven(
                opts, x_init, c, uc, noise, steps, t_enc, init_latent,
                eps_model, progress)
        if K.SAMPLER_SCHEDULE[name] == "model":
            sigmas = sched.get_sigmas(steps)
        else:
            sigmas = S.get_sigmas_karras(steps, sched.sigma_min,
                                         sched.sigma_max)
        kwargs = {}
        if name in K.CHURN_SAMPLERS:
            kwargs = dict(s_churn=opts.sampler_s_churn,
                          s_tmin=opts.sampler_s_tmin,
                          s_tmax=opts.sampler_s_tmax,
                          s_noise=opts.sampler_s_noise)
        den = cfg_denoiser(EpsDenoiser(eps_model, sched), c, uc, scale)
        x = x_init
        if t_enc is not None:       # k-space stochastic encode
            sigmas = S.truncate_for_img2img(sigmas, t_enc)
            x = init_latent.float() + noise.encode(
                tuple(init_latent.shape)) * float(sigmas[0])
        return K.SAMPLERS[name](den, x, sigmas, noise, progress_cb=progress,
                                **kwargs)

    def _sample_t_driven(self, opts, x_init, c, uc, noise: NoiseSource,
                         steps: int, t_enc: Optional[int], init_latent,
                         eps_model, progress) -> torch.Tensor:
        """DDIM, PLMS, DPM Solver and LCM on the model's alphas_cumprod;
        img2img (t_enc) through each one's own stochastic encode."""
        name, scale = opts.sampler, float(opts.scale)
        sched = self.bundle.schedule
        acp = sched.alphas_cumprod
        eps_cfg = cfg_denoiser(eps_model, c, uc, scale)
        if name == "DPM Solver":
            if t_enc is not None:
                raise ValueError("DPM Solver supports txt2img only (the "
                                 "reference exposes it for full sampling "
                                 "runs only)")
            return LDMX.sample_dpm_solver(
                eps_cfg, x_init, LDMX.make_dpm_solver_schedule(acp, steps),
                progress_cb=progress)
        enc = (None if t_enc is None
               else noise.encode(tuple(init_latent.shape)))
        if name == "LCM":
            # img2img maps t_enc to diffusers' strength-truncated origin
            # grid (strength = t_enc / steps, t_enc steps run) and encodes
            # to its top sigma in k-space
            lsched = LCM.make_lcm_schedule(
                acp, steps if t_enc is None else t_enc,
                strength=1.0 if t_enc is None else t_enc / steps)
            x = x_init if t_enc is None else (
                init_latent.float() + enc * float(lsched.sigmas[0]))
            den = cfg_denoiser(EpsDenoiser(eps_model, sched), c, uc, scale)
            return LCM.sample_lcm(den, x, lsched, noise, progress_cb=progress)
        ddim = DDIM.make_ddim_schedule(
            acp, steps, eta=0.0 if name == "PLMS" else opts.ddim_eta)
        x = x_init if t_enc is None else DDIM.stochastic_encode(
            init_latent, ddim, t_enc - 1, enc)
        if name == "PLMS":
            return LDMX.sample_plms(eps_cfg, x, ddim, t_start=t_enc,
                                    progress_cb=progress)
        return DDIM.sample(eps_cfg, x, ddim, noise, t_start=t_enc,
                           progress_cb=progress)

    def txt2img_latents(self, opts: GenerationOptions, c, uc,
                        noise: NoiseSource,
                        status_cb: StatusCb = _noop_status,
                        hint: Optional[torch.Tensor] = None,
                        control_weight: float = 1.0) -> torch.Tensor:
        """-> (B, H/f, W/f, 4) float32 latents (hires fix included; the
        ControlNet, given `hint`, steers the first pass only, as in the
        JAX pipeline)."""
        h, w = opts.H // opts.f, opts.W // opts.f
        b = c.shape[0]
        x = noise.initial((b, h, w, self.bundle.unet.cfg.out_channels)) * \
            self._sigma0(opts)
        lat = self._sample(opts, x, c, uc, noise, opts.sampling_steps,
                           status_cb=status_cb, hint=hint,
                           control_weight=control_weight)
        if opts.use_hires_fix and opts.hires_fix_scale_factor > 1.0:
            lat = self._hires_fix(opts, lat, c, uc, noise.hires(), status_cb)
        return lat

    def _hires_fix(self, opts, lat, c, uc, noise: NoiseSource, status_cb):
        """Upscale the latent ("Latent": nearest; "Lanczos": decode, a
        Lanczos-3 pixel resize, encode), then img2img at the new size.
        New latent sides are int(side * factor) rounded down to a multiple
        of 8, at least 8."""
        f = opts.hires_fix_scale_factor
        b, h, w, ch = lat.shape
        nh, nw = max(int(h * f) // 8 * 8, 8), max(int(w * f) // 8 * 8, 8)
        vae = self.bundle.vae
        if opts.hires_fix_upscaler.lower() == "lanczos":
            img = resize(decode_from_latent(vae, lat), (nh * 8, nw * 8),
                         "lanczos3")
            up = encode_to_latent(vae, img.to(torch.bfloat16))
        else:
            up = resize(lat, (nh, nw), "nearest")
        t_enc = max(1, int(opts.strength * opts.sampling_steps))
        return self._sample(opts, None, c, uc, noise, opts.sampling_steps,
                            t_enc=t_enc, init_latent=up, status_cb=status_cb)

    def _image(self, image: np.ndarray) -> torch.Tensor:
        """(H, W, 3) float host image -> (1, H, W, 3) bf16 on the device."""
        return torch.as_tensor(np.asarray(image, np.float32))[None].to(
            self.device, torch.bfloat16)

    def img2img_latents(self, opts: GenerationOptions, init_image: np.ndarray,
                        c, uc, noise: NoiseSource,
                        status_cb: StatusCb = _noop_status) -> torch.Tensor:
        """init_image: (H, W, 3) float in [-1, 1]; encoded once, at batch
        1, with the posterior sampled, then broadcast over the batch."""
        lat = encode_to_latent(self.bundle.vae, self._image(init_image),
                               posterior_noise=noise.posterior)
        lat = lat.expand((c.shape[0],) + lat.shape[1:]).float()
        t_enc = max(1, int(opts.strength * opts.sampling_steps))
        return self._sample(opts, None, c, uc, noise, opts.sampling_steps,
                            t_enc=t_enc, init_latent=lat, status_cb=status_cb)

    def inpaint_latents(self, opts: GenerationOptions, init_image: np.ndarray,
                        mask: np.ndarray, c, uc, noise: NoiseSource,
                        status_cb: StatusCb = _noop_status):
        """9-channel inpainting: the UNet sees [x, mask, masked-image
        latent]. init_image (H, W, 3) in [-1, 1]; mask (H, W) in [0, 1],
        1 where to inpaint, binarized at 0.5. -> (latents, binary mask)."""
        b = c.shape[0]
        mask_b = (np.asarray(mask) >= 0.5).astype(np.float32)
        masked = np.asarray(init_image) * (1.0 - mask_b[..., None])
        masked_lat = encode_to_latent(self.bundle.vae, self._image(masked))
        h8, w8 = masked_lat.shape[1:3]
        mask_lat = resize(torch.as_tensor(mask_b, device=self.device)
                          [None, :, :, None], (h8, w8), "nearest")
        extra = torch.cat([mask_lat.float(), masked_lat.float()], dim=-1)
        extra = extra.expand((b,) + extra.shape[1:])
        x = noise.initial((b, h8, w8, self.bundle.unet.cfg.out_channels)) * \
            self._sigma0(opts)
        lat = self._sample(opts, x, c, uc, noise, opts.sampling_steps,
                           extra=extra, status_cb=status_cb)
        return lat, mask_b

    def generate(
        self,
        opts: GenerationOptions,
        status_cb: StatusCb = _noop_status,
        result_cb: Optional[Callable[[np.ndarray, Dict[str, Any]], None]] = None,
        noise: Optional[NoiseFactory] = None,
        init_image: Optional[np.ndarray] = None,
        mask_image: Optional[np.ndarray] = None,
        control_image: Optional[np.ndarray] = None,
        control_weight: float = 1.0,
    ) -> List[Tuple[np.ndarray, Dict[str, Any]]]:
        """Run the job: n_iter batches x n_samples images.

        Returns [(image_01 (H, W, 3) float, generation_parameters dict)].
        `noise(seed, device)` builds the noise source of the batch whose
        first image has `seed`; by default a torch.Generator seeded with it.
        img2img takes `init_image` ((H, W, 3) in [-1, 1]); inpainting also
        `mask_image` ((H, W) in [0, 1], 1 where to inpaint). txt2img on a
        bundle with a ControlNet takes `control_image` ((H, W, 3) or
        (1, H, W, 3) in [0, 1]).
        """
        check_supported(opts)
        mode = opts.mode
        if (mode == MODE_INPAINTING) != self.bundle.inpaint:
            raise ValueError(f"mode {mode!r} on a bundle with the "
                             f"{'9' if self.bundle.inpaint else '4'}-channel "
                             "UNet: inpainting needs the inpaint UNet, the "
                             "other modes the plain one")
        if mode != MODE_TEXT_TO_IMAGE and init_image is None:
            raise ValueError(f"mode {mode!r} needs init_img")
        if mode == MODE_INPAINTING and mask_image is None:
            raise ValueError("inpainting needs mask_img")
        noise = noise or GeneratorNoise
        base_seed = resolve_seed(opts.seed)
        hint = None
        if control_image is not None and self.bundle.controlnet is not None:
            # in [0, 1], NHWC (the reference cldm hint range) -> NCHW
            h = torch.as_tensor(np.asarray(control_image, np.float32))
            h = h[None] if h.ndim == 3 else h
            hint = h.permute(0, 3, 1, 2).to(
                self.device, self.bundle.controlnet.cfg.dtype).contiguous()
        wildcards = bool(opts.wildcards_path) and os.path.isdir(opts.wildcards_path)
        results = []
        img_index = 0
        with torch.no_grad():
            for it in range(opts.n_iter):
                job = dataclasses.replace(opts)
                if wildcards:
                    job.prompt = resolve_wildcards(
                        opts.prompt, opts.wildcards_path,
                        rng=base_seed + img_index)
                    job.negative_prompt = resolve_wildcards(
                        opts.negative_prompt, opts.wildcards_path,
                        rng=base_seed + img_index + 1)
                b = opts.n_samples
                status_cb(f"batch {it + 1}/{opts.n_iter}: encoding prompt")
                c, uc = self._conditioning(job, b)
                src = noise(base_seed + img_index, self.device)
                t0 = time.perf_counter()
                mask_b = None
                if mode == MODE_TEXT_TO_IMAGE:
                    lat = self.txt2img_latents(job, c, uc, src, status_cb,
                                               hint, control_weight)
                elif mode == MODE_IMAGE_TO_IMAGE:
                    lat = self.img2img_latents(job, init_image, c, uc, src,
                                               status_cb)
                else:
                    lat, mask_b = self.inpaint_latents(
                        job, init_image, mask_image, c, uc, src, status_cb)
                status_cb("decoding")
                imgs = device_to_img01(decode_from_latent(
                    self.bundle.vae, lat.to(torch.bfloat16)))
                if mask_b is not None:
                    # the inpainted region over the original
                    init01 = (np.asarray(init_image, np.float32) + 1.0) / 2.0
                    m = mask_b[None, :, :, None]
                    imgs = imgs * m + init01[None] * (1.0 - m)
                logger.info("sampling+decode took %.2fs",
                            time.perf_counter() - t0)
                flags = None
                if job.safety_check:
                    imgs, flags = self.safety.check(imgs)
                for i in range(b):
                    img = embed_watermark(imgs[i]) if job.watermark else imgs[i]
                    meta = dataclasses.asdict(job)
                    meta["seed"] = base_seed + img_index
                    meta.pop("extra", None)
                    if flags is not None:
                        meta["nsfw"] = flags[i]
                    results.append((img, meta))
                    if result_cb is not None:
                        result_cb(img, meta)
                    img_index += 1
        return results


def build_sd15_bundle(device=None, dtype: torch.dtype = torch.bfloat16,
                      seed: int = 0,
                      unet_cfg: Optional[UNetConfig] = None,
                      vae_cfg: Optional[VAEConfig] = None,
                      clip_cfg: Optional[CLIPTextConfig] = None,
                      inpaint: bool = False) -> SD15Bundle:
    """An SD1.5 bundle with seeded random weights, built on `device` in
    `dtype` (default: the full SD1.5 configs); `inpaint` gives the UNet
    the inpainting checkpoints' 9 input channels. For tests and smoke runs:
    pipelines/loader.py loads a bundle from checkpoint files."""
    device = resolve_device(device)
    unet_cfg = unet_cfg or sd15_unet_config(dtype=dtype)
    if inpaint:
        unet_cfg = dataclasses.replace(unet_cfg, in_channels=9)
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
