"""SVD img2vid (the port of cremage_tpu/pipelines/svd.py).

Behavior contract (the reference's svd_video_generator): the input image
-> `num_frames` latent frames through the video UNet (models/video_unet.py)
under EulerEDMSampler with s_churn 0 over EDM sigmas (sigma_min 0.002,
sigma_max 700, rho 7) and the LinearPredictionGuider over [uc; c], its
scale linear from min_guidance_scale to max_guidance_scale over the
frames. The conditioning:
- crossattn: the CLIP-H image embedding of the input resized to 224^2
  (cv2's INTER_AREA, utils/resize.py `resize_area`), one token per frame;
  zeros when the bundle has no image tower, as in JAX;
- vector: the 256-wide Fourier embeddings of fps_id, motion_bucket_id and
  cond_aug (768);
- concat: the VAE posterior mean (unscaled, as JAX takes it) of the image
  plus cond_aug times noise, cast to bf16 on the way in, repeated per
  frame (the UNet's in_channels 8);
- uc: zero crossattn and concat, the same vector.
The v-prediction denoiser with c_noise = 0.25 log sigma (sgm
VScalingWithEDMcNoise); `decoding_t` frames per VAE decode (the image
decoder); frames quantized to uint8 on the device, written as
frame_{i:05}.png into `output_dir` when one is named.

Every random number comes from the request's `NoiseSource` (core/rng.py):
`initial` the latent noise (JAX's key), `cond_aug` the conditioning
frame's (JAX's fold_in(key, 3)). DeepCache, ToMe, AdaCache and the
pipeline-parallel mesh raise NotImplementedError.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from cremage_tpu_torch.core.rng import GeneratorNoise, resolve_device, resolve_seed
from cremage_tpu_torch.io.png import encode_png, image_to_uint8
from cremage_tpu_torch.models.clip_vision import CLIPVisionModel
from cremage_tpu_torch.models.vae import AutoencoderKL, decode_from_latent
from cremage_tpu_torch.models.video_unet import VideoUNet
from cremage_tpu_torch.pipelines.sdxl import fourier_vector_embedding
from cremage_tpu_torch.samplers import edm as EDM
from cremage_tpu_torch.samplers.denoiser import _bcast_sigma
from cremage_tpu_torch.utils.image import device_to_img01
from cremage_tpu_torch.utils.resize import resize_area


@dataclasses.dataclass
class SVDOptions:
    """The JAX package's SVDOptions (the reference tool's parameters)."""

    num_frames: int = 14
    num_steps: int = 25
    fps_id: int = 6
    motion_bucket_id: int = 127
    cond_aug: float = 0.02
    min_guidance_scale: float = 1.0
    max_guidance_scale: float = 2.5
    sigma_min: float = 0.002
    sigma_max: float = 700.0
    rho: float = 7.0
    seed: int = -1
    decoding_t: int = 1       # frames decoded per VAE call
    deep_cache: int = 1       # not ported: > 1 raises
    deep_cache_branch: int = 1
    tome_ratio: float = 0.0   # not ported: > 0 raises
    ada_cache: float = 0.0    # not ported: > 0 raises


@dataclasses.dataclass
class SVDBundle:
    unet: VideoUNet
    vae: AutoencoderKL
    clip_vision: Optional[CLIPVisionModel] = None
    # pipelines/loader.py: the file's bytes and load seconds, 8-bit storage
    load_report: Optional[Dict[str, Any]] = None


def _noop(msg) -> None:
    pass


def check_supported(opts: SVDOptions) -> None:
    """JAX's range check of tome_ratio, then NotImplementedError for the
    speed features this port does not run (the JAX pipeline runs them)."""
    if not 0.0 <= float(opts.tome_ratio) < 0.75:
        raise ValueError(f"tome_ratio must be in [0, 0.75), got "
                         f"{opts.tome_ratio}")
    unsupported = {"deep_cache": int(opts.deep_cache) >= 2,
                   "tome_ratio": float(opts.tome_ratio) > 0.0,
                   "ada_cache": float(opts.ada_cache) > 0.0}
    bad = {k: getattr(opts, k) for k, v in unsupported.items() if v}
    if bad:
        raise NotImplementedError(f"the PyTorch SVD pipeline does not run "
                                  f"the speed features yet: {bad}")


class SVDPipeline:
    def __init__(self, bundle: SVDBundle, device=None):
        self.device = resolve_device(device)
        self.bundle = bundle
        for m in (bundle.unet, bundle.vae, bundle.clip_vision):
            if m is not None:
                m.to(self.device).eval()

    def use_mesh_pp(self, *args, **kwargs):
        raise NotImplementedError("the pipeline-parallel video UNet "
                                  "(use_mesh_pp) is not ported")

    def image_embedding(self, image01: np.ndarray) -> torch.Tensor:
        """(H, W, 3) in [0, 1] -> (1, context_dim) float32: the CLIP-H
        embedding of the image resized to the tower's size, or zeros
        without a tower."""
        model = self.bundle.clip_vision
        if model is None:
            return torch.zeros(1, self.bundle.unet.cfg.context_dim,
                               device=self.device)
        img = torch.as_tensor(np.asarray(image01, np.float32),
                              device=self.device)[None]
        size = model.cfg.image_size
        return model(resize_area(img, (size, size)))

    def _denoise(self, opts: SVDOptions, ctx, vector, concat) -> Callable:
        unet = self.bundle.unet

        def network(x, c_noise, cond):
            xin = torch.cat([x, cond["concat"].to(x.dtype)], dim=-1)
            out = unet(xin.permute(0, 3, 1, 2).contiguous(), c_noise,
                       cond["crossattn"], cond["vector"])
            return out.permute(0, 2, 3, 1)

        def denoiser(x, sigma, cond):
            sigma = _bcast_sigma(sigma, x.shape[0], x.device)
            s = sigma.reshape(-1, 1, 1, 1)
            c_skip = 1.0 / (s ** 2 + 1.0)
            c_out = -s / torch.sqrt(s ** 2 + 1.0)
            c_in = 1.0 / torch.sqrt(s ** 2 + 1.0)
            v = network(x * c_in, 0.25 * torch.log(sigma), cond)
            return v.float() * c_out + x * c_skip

        c = {"crossattn": ctx, "vector": vector, "concat": concat}
        uc = {"crossattn": torch.zeros_like(ctx), "vector": vector,
              "concat": torch.zeros_like(concat)}
        return EDM.linear_prediction_guider(
            denoiser, c, uc, scale=opts.max_guidance_scale,
            num_frames=opts.num_frames, min_scale=opts.min_guidance_scale,
            max_scale=opts.max_guidance_scale)

    def sample(self, image01: np.ndarray, opts: SVDOptions,
               status_cb=_noop, output_dir: Optional[str] = None,
               noise: Optional[Callable] = None) -> np.ndarray:
        """(H, W, 3) image in [0, 1] (H, W multiples of 64) -> (T, H, W, 3)
        frames in [0, 1] (uint8 steps). `noise(seed, device)` builds the
        request's noise source (GeneratorNoise by default)."""
        check_supported(opts)
        if self.bundle.unet.num_frames != opts.num_frames:
            raise ValueError(f"the video UNet was built for "
                             f"{self.bundle.unet.num_frames} frames, the "
                             f"request asks for {opts.num_frames}")
        src = (noise or GeneratorNoise)(resolve_seed(opts.seed), self.device)
        t, dev = opts.num_frames, self.device
        h8, w8 = image01.shape[0] // 8, image01.shape[1] // 8
        vae = self.bundle.vae
        with torch.no_grad():
            status_cb("conditioning")
            emb = self.image_embedding(image01)
            ctx = emb[None].expand(t, 1, emb.shape[-1])
            vector = torch.as_tensor(np.concatenate([
                fourier_vector_embedding([opts.fps_id]),
                fourier_vector_embedding([opts.motion_bucket_id]),
                fourier_vector_embedding([opts.cond_aug])]), device=dev)
            vector = vector[None].expand(t, vector.shape[0])
            img = torch.as_tensor(np.asarray(image01, np.float32),
                                  device=dev)[None] * 2.0 - 1.0
            img = img + src.cond_aug(tuple(img.shape)) * opts.cond_aug
            # bf16 on the way in, as JAX casts it whatever the VAE's dtype
            mean, _ = vae.encode(img.to(torch.bfloat16).to(vae.cfg.dtype)
                                 .permute(0, 3, 1, 2).contiguous())
            concat = mean.float().permute(0, 2, 3, 1).expand(t, h8, w8, -1)
            x = src.initial((t, h8, w8, 4))
            status_cb("sampling")
            sigmas = EDM.EDMDiscretization(opts.sigma_min, opts.sigma_max,
                                           opts.rho)(opts.num_steps)
            lat = EDM.run_sgm_sampler(
                "EulerEDMSampler", self._denoise(opts, ctx, vector, concat),
                x, sigmas, src, progress_cb=lambda i: status_cb(
                    f"Sampling {i + 1} / {opts.num_steps}"))
            status_cb("decoding frames")
            step = max(1, int(opts.decoding_t))
            frames = np.concatenate([
                device_to_img01(decode_from_latent(
                    vae, lat[i:i + step].to(torch.bfloat16)))
                for i in range(0, t, step)], axis=0)
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            for i, f in enumerate(frames):
                with open(os.path.join(output_dir, f"frame_{i:05}.png"),
                          "wb") as fh:
                    fh.write(encode_png(image_to_uint8(f)))
        return frames
