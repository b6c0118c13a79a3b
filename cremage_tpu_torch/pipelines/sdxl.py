"""SDXL pipeline: base txt2img and img2img (the port of
cremage_tpu/pipelines/sdxl.py without the refiner and inpainting).

Behavior contract (sgm GeneralConditioner and the reference's SDXL
generator):
- crossattn = concat(CLIP-L hidden_states[11] chunks, OpenCLIP-bigG
  penultimate chunks) -> (B, 77 n, 2048), the shorter tower's chunks
  padded with its own empty-prompt chunk, then c and uc filler-padded to
  the same length;
- vector = concat(bigG pooled output (ln_final at each chunk's last EOS,
  @ text_projection, averaged over the chunks), 256-wide Fourier
  embeddings of original_size (H, W), crop_coords (0, 0) and target_size
  (H, W)) -> (B, 2816);
- the sgm sampler menu under a discretization and a guider
  (samplers/edm.py); txt2img scales N(0, 1) noise by sqrt(1 + sigma0^2);
  img2img encodes the init image to the posterior mean, keeps the last
  t_enc = max(1, int(strength * steps)) sigmas and adds noise * sigma0;
- the latent rounded to bf16 and decoded, quantized to uint8 on the
  device, the image safety check (flags in the metadata as "nsfw"), the
  watermark, and per-image seed = seed + i.

Every random number comes from the batch's `NoiseSource` (core/rng.py):
`initial` the txt2img noise, `encode` the img2img noise, `step` the
samplers' draws. Every option this port does not run raises
NotImplementedError (`check_supported`).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.core.config import (
    GenerationOptions, MODE_IMAGE_TO_IMAGE, MODE_TEXT_TO_IMAGE,
)
from cremage_tpu_torch.core.rng import GeneratorNoise, NoiseSource, resolve_device, resolve_seed
from cremage_tpu_torch.io.ti import load_embedding
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.layers import set_compute_dtype, timestep_embedding
from cremage_tpu_torch.models.open_clip import OpenCLIPTextModel, openclip_bigg_config
from cremage_tpu_torch.models.unet import UNetModel, sdxl_base_unet_config
from cremage_tpu_torch.models.vae import (
    AutoencoderKL, decode_from_latent, encode_to_latent, sdxl_vae_config,
)
from cremage_tpu_torch.prompt.chunking import generate_weighted_chunks, make_ti_fetch
from cremage_tpu_torch.prompt.parser import compute_prompt_score
from cremage_tpu_torch.prompt.tokenizer import CLIPTokenizer, default_tokenizer
from cremage_tpu_torch.samplers import edm as EDM
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.services.safety import ImageSafetyChecker, default_image_safety
from cremage_tpu_torch.services.watermark import embed_watermark
from cremage_tpu_torch.utils.image import device_to_img01

logger = logging.getLogger(__name__)

StatusCb = Callable[[str], None]
NoiseFactory = Callable[[int, torch.device], NoiseSource]

SDXL_SAMPLERS = tuple(EDM.SGM_SAMPLER_NAMES)
SDXL_MODES = (MODE_TEXT_TO_IMAGE, MODE_IMAGE_TO_IMAGE)
_MEMO = 32      # memoized tower encodes per conditioner (FIFO)


def fourier_vector_embedding(values, outdim: int = 256) -> np.ndarray:
    """Each scalar -> its timestep embedding (outdim), flattened (sgm
    ConcatTimestepEmbedderND)."""
    vals = torch.as_tensor(np.asarray(values, np.float32).reshape(-1))
    return timestep_embedding(vals, outdim).numpy().reshape(-1)


class SDXLConditioner:
    """Both text towers and the size/crop/target vector. Each tower runs on
    the device its weights are on; encodes are memoized per prompt (prompts
    with TI tags are not: their files can change on disk)."""

    def __init__(self, clip_l: CLIPTextModel, open_clip: OpenCLIPTextModel,
                 tokenizer: CLIPTokenizer, embedding_dir: Optional[str] = None):
        self.clip_l = clip_l
        self.open_clip = open_clip
        self.tokenizer = tokenizer
        self.embedding_dir = embedding_dir
        self._l_cache: Dict[str, np.ndarray] = {}
        self._g_cache: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}

    @staticmethod
    def _device(model) -> torch.device:
        return next(model.parameters()).device

    def _chunks(self, prompt: str, model, tower_key: str):
        def embed(ids):
            t = torch.as_tensor(np.asarray(ids, np.int64),
                                device=self._device(model))
            return model.embed_tokens(t).float().cpu().numpy()
        ti = make_ti_fetch(self.embedding_dir, load_embedding,
                           tower_key=tower_key)
        return generate_weighted_chunks(self.tokenizer, embed,
                                        compute_prompt_score(prompt),
                                        ti_fetch=ti)

    @staticmethod
    def _memo(cache: dict, prompt: str, value):
        if "<" in prompt:
            return value
        if len(cache) >= _MEMO:
            cache.pop(next(iter(cache)))
        cache[prompt] = value
        return value

    def _encode_l(self, prompt: str) -> np.ndarray:
        """CLIP-L hidden_states[num_layers - 1] of each chunk."""
        hit = self._l_cache.get(prompt) if "<" not in prompt else None
        if hit is not None:
            return hit
        model = self.clip_l
        chunks, _ = self._chunks(prompt, model, "clip_l")
        dev = self._device(model)
        outs = []
        for ch in chunks:
            _, hidden = model(torch.as_tensor(ch[None], device=dev))
            outs.append(hidden[model.cfg.num_layers - 1][0].float().cpu().numpy())
        return self._memo(self._l_cache, prompt, np.concatenate(outs, axis=0))

    def _encode_g(self, prompt: str) -> Tuple[np.ndarray, np.ndarray]:
        """bigG penultimate chunks and the chunks' mean pooled output."""
        hit = self._g_cache.get(prompt) if "<" not in prompt else None
        if hit is not None:
            return hit
        model = self.open_clip
        chunks, eos_list = self._chunks(prompt, model, "clip_g")
        dev = self._device(model)
        outs, pooled = [], []
        for ch, eos in zip(chunks, eos_list):
            hidden, final = model(torch.as_tensor(ch[None], device=dev))
            outs.append(hidden[model.cfg.num_layers - 1][0].float().cpu().numpy())
            p = model.project_pooled(final, torch.tensor([eos], device=dev))
            pooled.append(p[0].cpu().numpy())
        out = (np.concatenate(outs, axis=0), np.stack(pooled).mean(axis=0))
        return self._memo(self._g_cache, prompt, out)

    def encode_cond(self, prompt: str, *, orig_size: Tuple[int, int],
                    crop_coords: Tuple[int, int] = (0, 0),
                    target_size: Optional[Tuple[int, int]] = None,
                    zero_text: bool = False) -> Dict[str, np.ndarray]:
        """-> {"crossattn": (77 n, 2048), "vector": (2816,)} float32."""
        with torch.no_grad():
            g_cross, pooled = self._encode_g(prompt)
            l_cross = self._encode_l(prompt)
            # align the towers' chunk counts (a long prompt tokenizes to
            # different lengths per tower): pad with the empty prompt's chunk
            while l_cross.shape[0] < g_cross.shape[0]:
                l_cross = np.concatenate([l_cross, self._encode_l("")], axis=0)
            while g_cross.shape[0] < l_cross.shape[0]:
                g_cross = np.concatenate([g_cross, self._encode_g("")[0]],
                                         axis=0)
        cross = np.concatenate([l_cross, g_cross], axis=-1)
        if zero_text:
            cross, pooled = np.zeros_like(cross), np.zeros_like(pooled)
        vector = np.concatenate([
            pooled, fourier_vector_embedding(orig_size),
            fourier_vector_embedding(crop_coords),
            fourier_vector_embedding(target_size or orig_size)], axis=0)
        return {"crossattn": cross, "vector": vector}

    def encode_pair(self, opts: GenerationOptions, batch: int,
                    device=None, force_uc_zero: bool = False):
        """(c, uc) for a batch: dicts of float32 tensors on `device`, the
        crossattn of c and uc filler-padded to the same length."""
        size = (opts.H, opts.W)
        c = self.encode_cond(opts.prompt, orig_size=size)
        uc = self.encode_cond(opts.negative_prompt, orig_size=size,
                              zero_text=force_uc_zero)
        for a, b in ((c, uc), (uc, c)):
            while a["crossattn"].shape[0] < b["crossattn"].shape[0]:
                a["crossattn"] = np.concatenate(
                    [a["crossattn"],
                     self.encode_cond("", orig_size=size)["crossattn"]], axis=0)

        def tile(d):
            out = {}
            for k, v in d.items():
                t = torch.as_tensor(v, dtype=torch.float32, device=device)
                out[k] = t[None].expand((batch,) + t.shape)
            return out
        return tile(c), tile(uc)


@dataclasses.dataclass
class SDXLBundle:
    """All loaded model state of one SDXL base checkpoint."""

    unet: UNetModel
    conditioner: SDXLConditioner
    vae: AutoencoderKL
    # pipelines/loader.py: the files' bytes and load seconds, the LoRA merge
    load_report: Optional[Dict[str, Any]] = None


def _noop_status(msg: str) -> None:
    pass


def check_supported(opts: GenerationOptions) -> None:
    """Raise NotImplementedError for every option this port does not run
    yet (the JAX pipeline runs them all)."""
    unsupported = {
        "sampler": opts.sampler not in SDXL_SAMPLERS,
        "mode": opts.mode not in SDXL_MODES,
        "refiner": bool(opts.refiner_ckpt) or float(opts.refiner_strength) > 0,
        "guider": opts.guider not in EDM.GUIDERS,
        "cfg_interval": float(opts.cfg_interval_high) > float(opts.cfg_interval_low),
        "deep_cache": int(opts.deep_cache) > 1,
        "tome_ratio": float(opts.tome_ratio) > 0.0,
        "ada_cache": float(opts.ada_cache) > 0.0,
        "unet_quantize": opts.extra.get("unet_quantize") not in (None, "", "none"),
        "auto_face_fix": bool(opts.auto_face_fix),
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        vals = {k: (opts.extra.get(k) if k == "unet_quantize"
                    else getattr(opts, k, None)) for k in bad}
        raise NotImplementedError(
            f"the PyTorch SDXL pipeline runs the base model in the modes "
            f"{SDXL_MODES} with the samplers {SDXL_SAMPLERS} and the guiders "
            f"{tuple(EDM.GUIDERS)}; not ported: {vals}")


class SDXLPipeline:
    """`safety`: the image safety checker of jobs with safety_check on (by
    default `default_image_safety`, built at the first such job)."""

    def __init__(self, bundle: SDXLBundle, device=None,
                 safety: Optional[ImageSafetyChecker] = None):
        self.device = resolve_device(device)
        self.bundle = bundle
        self._safety = safety
        for m in (bundle.unet, bundle.vae, bundle.conditioner.clip_l,
                  bundle.conditioner.open_clip):
            m.to(self.device).eval()

    @property
    def safety(self) -> ImageSafetyChecker:
        if self._safety is None:
            self._safety = default_image_safety(device=self.device)
        return self._safety

    def _denoiser(self) -> EDM.DiscreteDenoiserSGM:
        unet = self.bundle.unet

        def network(x, t, cond):
            return unet(x.permute(0, 3, 1, 2).contiguous(), t,
                        cond["crossattn"], y=cond["vector"]).permute(0, 2, 3, 1)
        return EDM.DiscreteDenoiserSGM(
            network, EDM.LegacyDDPMDiscretization()(1000, do_append_zero=False))

    def sigmas(self, opts: GenerationOptions,
               t_enc: Optional[int] = None) -> np.ndarray:
        """The job's descending sigmas with a trailing 0 (the last t_enc + 1
        of them for img2img)."""
        disc = EDM.make_discretization(
            opts.discretization, sigma_min=opts.discretization_sigma_min,
            sigma_max=opts.discretization_sigma_max,
            rho=opts.discretization_rho)
        sigmas = disc(opts.sampling_steps)
        return sigmas if t_enc is None else S.truncate_for_img2img(sigmas, t_enc)

    def _sample(self, opts: GenerationOptions, x: torch.Tensor, c, uc,
                noise: NoiseSource, sigmas: np.ndarray, scale_input: bool,
                status_cb: StatusCb) -> torch.Tensor:
        total = len(sigmas) - 1
        denoise = EDM.GUIDERS[opts.guider](self._denoiser(), c, uc,
                                           scale=float(opts.scale))
        return EDM.run_sgm_sampler(
            opts.sampler, denoise, x, sigmas, noise,
            s_churn=opts.sampler_s_churn, s_tmin=opts.sampler_s_tmin,
            s_tmax=opts.sampler_s_tmax, s_noise=opts.sampler_s_noise,
            eta=opts.sampler_eta, order=opts.sampler_order,
            scale_input=scale_input,
            progress_cb=lambda i: status_cb(f"Sampling {i + 1} / {total}"))

    def txt2img_latents(self, opts: GenerationOptions, c, uc,
                        noise: NoiseSource,
                        status_cb: StatusCb = _noop_status) -> torch.Tensor:
        """-> (B, H/8, W/8, 4) float32 latents."""
        b = c["crossattn"].shape[0]
        x = noise.initial((b, opts.H // 8, opts.W // 8, 4))
        return self._sample(opts, x, c, uc, noise, self.sigmas(opts), True,
                            status_cb)

    def img2img_latents(self, opts: GenerationOptions, init_image: np.ndarray,
                        c, uc, noise: NoiseSource,
                        status_cb: StatusCb = _noop_status) -> torch.Tensor:
        """init_image: (H, W, 3) float in [-1, 1], encoded once to the
        posterior mean and broadcast over the batch."""
        img = torch.as_tensor(np.asarray(init_image, np.float32))[None].to(
            self.device, torch.bfloat16)
        lat0 = encode_to_latent(self.bundle.vae, img)
        lat0 = lat0.expand((c["crossattn"].shape[0],) + lat0.shape[1:])
        t_enc = max(1, int(opts.strength * opts.sampling_steps))
        sigmas = self.sigmas(opts, t_enc)
        x = lat0.float() + noise.encode(tuple(lat0.shape)) * float(sigmas[0])
        return self._sample(opts, x, c, uc, noise, sigmas, False, status_cb)

    def generate(
        self,
        opts: GenerationOptions,
        status_cb: StatusCb = _noop_status,
        result_cb: Optional[Callable[[np.ndarray, Dict[str, Any]], None]] = None,
        noise: Optional[NoiseFactory] = None,
        init_image: Optional[np.ndarray] = None,
        mask_image: Optional[np.ndarray] = None,
    ) -> List[Tuple[np.ndarray, Dict[str, Any]]]:
        """Run the job: n_iter batches x n_samples images, img2img when
        `init_image` ((H, W, 3) in [-1, 1]) is given, as in the JAX
        pipeline. Returns [(image_01 (H, W, 3) float, metadata)].
        `noise(seed, device)` builds the noise source of the batch whose
        first image has `seed`."""
        check_supported(opts)
        if mask_image is not None:
            raise NotImplementedError(
                "SDXL inpainting (the 9-channel model or the latent blend) "
                "is not ported")
        noise = noise or GeneratorNoise
        base_seed = resolve_seed(opts.seed)
        results = []
        img_index = 0
        with torch.no_grad():
            for it in range(opts.n_iter):
                b = opts.n_samples
                status_cb(f"batch {it + 1}/{opts.n_iter}: encoding prompt")
                c, uc = self.bundle.conditioner.encode_pair(opts, b, self.device)
                src = noise(base_seed + img_index, self.device)
                t0 = time.perf_counter()
                if init_image is not None:
                    lat = self.img2img_latents(opts, init_image, c, uc, src,
                                               status_cb)
                else:
                    lat = self.txt2img_latents(opts, c, uc, src, status_cb)
                status_cb("decoding")
                imgs = device_to_img01(decode_from_latent(
                    self.bundle.vae, lat.to(torch.bfloat16)))
                logger.info("sampling+decode took %.2fs",
                            time.perf_counter() - t0)
                flags = None
                if opts.safety_check:
                    imgs, flags = self.safety.check(imgs)
                for i in range(b):
                    img = embed_watermark(imgs[i]) if opts.watermark else imgs[i]
                    meta = dataclasses.asdict(opts)
                    meta["seed"] = base_seed + img_index
                    meta.pop("extra", None)
                    if flags is not None:
                        meta["nsfw"] = flags[i]
                    results.append((img, meta))
                    if result_cb is not None:
                        result_cb(img, meta)
                    img_index += 1
        return results


def build_sdxl_bundle(device=None, dtype: torch.dtype = torch.bfloat16,
                      seed: int = 0) -> SDXLBundle:
    """An SDXL base bundle at the published configs with seeded random
    weights on `device` in `dtype`. For smoke runs: pipelines/loader.py
    loads one from checkpoint files."""
    device = resolve_device(device)
    unet_cfg = sdxl_base_unet_config(dtype=dtype)
    vae_cfg = sdxl_vae_config(dtype=dtype)
    clip_cfg = CLIPTextConfig(dtype=dtype)
    openclip_cfg = openclip_bigg_config(dtype=dtype)
    fork = [device] if device.type == "cuda" else []
    with torch.random.fork_rng(devices=fork), torch.device(device):
        torch.manual_seed(seed)
        unet = set_compute_dtype(UNetModel(unet_cfg), dtype)
        vae = set_compute_dtype(AutoencoderKL(vae_cfg), dtype)
        clip = set_compute_dtype(CLIPTextModel(clip_cfg), dtype)
        oc = set_compute_dtype(OpenCLIPTextModel(openclip_cfg), dtype)
    cond = SDXLConditioner(clip.eval(), oc.eval(), default_tokenizer())
    return SDXLBundle(unet=unet.eval(), conditioner=cond, vae=vae.eval())
