"""FLUX.1 txt2img pipeline (packed-latent flow transformer) — the port of
cremage_tpu/pipelines/flux.py.

Behavior contract (the JAX pipeline's):
- the conditioner gives CLIP-L's pooled output (the final-LayerNorm state
  at the first EOS) and the T5 context of `t5_len` (256) tokens, or zeros
  of that shape when there is no T5 tower or no T5 tokenizer;
- per batch: the statuses "encoding prompt", "i / n" after each step and
  "decoding"; the initial noise is the batch's `NoiseSource.initial` at
  JAX's (B, H/8, W/8, 16) draw, packed 2x2 into 64-channel tokens; flow
  Euler over the unshifted sigmas (schnell) or the mu-shifted ones with
  the guidance embedding (dev, guidance = opts.scale); unpack, round to
  bf16, decode, uint8 on the device;
- the image safety check (flagged images swapped; the JAX FLUX pipeline
  writes no flag into the metadata), the watermark, seed = seed + i.

The speed features (deep_cache, ada_cache, tome_ratio) and the sequence-
and pipeline-parallel meshes are not ported: `check_supported` and the
mesh methods raise NotImplementedError. cfg_interval raises JAX's own
ValueError (FLUX's guidance is distilled: no CFG batch to skip). The
sampler name and the mode are not read, as in JAX (txt2img only).
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import GeneratorNoise, NoiseSource, resolve_device, resolve_seed
from cremage_tpu_torch.models.clip import CLIPTextModel
from cremage_tpu_torch.models.flux import (
    FluxModel, make_position_ids, pack_latents, unpack_latents,
)
from cremage_tpu_torch.models.t5 import T5Encoder
from cremage_tpu_torch.models.vae import AutoencoderKL, decode_from_latent
from cremage_tpu_torch.prompt.sentencepiece import as_t5_tokenize
from cremage_tpu_torch.prompt.tokenizer import EOS, CLIPTokenizer
from cremage_tpu_torch.samplers import flow as F
from cremage_tpu_torch.services.safety import ImageSafetyChecker, default_image_safety
from cremage_tpu_torch.services.watermark import embed_watermark
from cremage_tpu_torch.utils.image import device_to_img01

logger = logging.getLogger(__name__)

StatusCb = Callable[[str], None]
NoiseFactory = Callable[[int, torch.device], NoiseSource]


class FluxConditioner:
    """CLIP-L pooled (768) + T5 context tokens (t5_len, d_model)."""

    def __init__(self, clip_l: CLIPTextModel, tokenizer: CLIPTokenizer,
                 t5: Optional[T5Encoder] = None, t5_tokenize=None,
                 t5_len: int = 256):
        self.clip_l = clip_l
        self.tokenizer = tokenizer
        self.t5 = t5
        self.t5_tokenize = as_t5_tokenize(t5_tokenize, t5_len)
        self.t5_len = t5_len

    @torch.no_grad()
    def encode(self, prompt: str) -> Dict[str, torch.Tensor]:
        """-> {"txt": (t5_len, d) float32, "vec": (768,) float32}, on the
        CLIP tower's device."""
        dev = self.clip_l.embeddings.token_embedding.weight.device
        ids = self.tokenizer.encode_with_specials(prompt)
        ids_t = torch.tensor([ids], device=dev)
        last, _ = self.clip_l(self.clip_l.embed_tokens(ids_t))
        vec = last[0, ids.index(EOS)].float()
        d = self.t5.cfg.d_model if self.t5 is not None else 4096
        if self.t5 is not None and self.t5_tokenize is not None:
            tids = np.asarray(self.t5_tokenize(prompt), np.int64)[: self.t5_len]
            tids = np.pad(tids, (0, self.t5_len - len(tids)))
            txt = self.t5(torch.from_numpy(tids[None]).to(dev))[0].float()
        else:
            txt = torch.zeros(self.t5_len, d, device=dev)
        return {"txt": txt, "vec": vec}


@dataclasses.dataclass
class FluxBundle:
    model: FluxModel
    conditioner: FluxConditioner
    vae: AutoencoderKL
    load_report: Optional[Dict] = None


def _noop_status(msg: str) -> None:
    pass


def check_supported(opts: GenerationOptions) -> None:
    """Raise for every option the FLUX port does not run: JAX's own
    ValueError for cfg_interval, NotImplementedError for the rest."""
    lo, hi = float(opts.cfg_interval_low), float(opts.cfg_interval_high)
    if hi > lo:
        if lo < 0:
            raise ValueError(f"cfg_interval_low must be >= 0, got {lo}")
        raise ValueError(
            "cfg_interval does not apply to FLUX: guidance is distilled "
            "into the guidance embedding (no doubled CFG batch to skip)")
    unsupported = {
        "deep_cache": int(opts.deep_cache) >= 2,
        "ada_cache": float(opts.ada_cache) > 0.0,
        "tome_ratio": float(opts.tome_ratio) > 0.0,
    }
    bad = {k: getattr(opts, k) for k, v in unsupported.items() if v}
    if bad:
        raise NotImplementedError(
            f"the PyTorch FLUX pipeline runs txt2img with flow Euler; not "
            f"ported: {bad}")


class FluxPipeline:
    """`safety`: the image safety checker of jobs with safety_check on (by
    default `default_image_safety`, built at the first such job)."""

    def __init__(self, bundle: FluxBundle, device=None,
                 safety: Optional[ImageSafetyChecker] = None):
        self.bundle = bundle
        self.device = resolve_device(device)
        self._safety = safety
        cond = bundle.conditioner
        for m in (bundle.model, bundle.vae, cond.clip_l, cond.t5):
            if m is not None:
                m.to(self.device).eval()

    @property
    def safety(self) -> ImageSafetyChecker:
        if self._safety is None:
            self._safety = default_image_safety(device=self.device)
        return self._safety

    def use_mesh_sp(self, *args, **kw):
        raise NotImplementedError("FLUX's sequence-parallel mesh is not ported")

    def use_mesh_pp(self, *args, **kw):
        raise NotImplementedError("FLUX's pipeline-parallel mesh is not ported")

    def sigmas(self, opts: GenerationOptions, hp: int, wp: int) -> np.ndarray:
        if self.bundle.model.cfg.guidance_embed:
            return F.flow_sigmas(opts.sampling_steps, mu=F.flux_mu(hp * wp))
        return F.flow_sigmas(opts.sampling_steps)

    def sample(self, opts: GenerationOptions, x_tokens: torch.Tensor,
               txt: torch.Tensor, vec: torch.Tensor, hp: int, wp: int,
               status_cb: StatusCb = _noop_status) -> torch.Tensor:
        """Flow Euler from packed noise tokens (B, hp * wp, 64) -> float32
        tokens."""
        model = self.bundle.model
        b = x_tokens.shape[0]
        sigmas = self.sigmas(opts, hp, wp)
        txt_ids, img_ids = make_position_ids(hp, wp, txt.shape[1])
        freqs = model.freqs(img_ids, txt_ids, x_tokens.device)
        guidance = (torch.full((b,), float(opts.scale), device=x_tokens.device)
                    if model.cfg.guidance_embed else None)

        def v_fn(x, sigma):
            return model(x, txt, sigma.expand(b), vec, img_ids, txt_ids,
                         guidance, freqs=freqs)

        n = len(sigmas) - 1
        return F.sample_flow_euler(v_fn, x_tokens, sigmas,
                                   lambda i: status_cb(f"{i + 1} / {n}"))

    def generate(
        self,
        opts: GenerationOptions,
        status_cb: StatusCb = _noop_status,
        result_cb: Optional[Callable[[np.ndarray, Dict[str, Any]], None]] = None,
        noise: Optional[NoiseFactory] = None,
    ) -> List[Tuple[np.ndarray, Dict[str, Any]]]:
        """n_iter batches x n_samples images. Returns [(image_01 (H, W, 3)
        float, metadata)]; `noise(seed, device)` builds the noise source of
        the batch whose first image has `seed`."""
        check_supported(opts)
        noise = noise or GeneratorNoise
        base_seed = resolve_seed(opts.seed)
        results = []
        img_index = 0
        with torch.no_grad():
            for _ in range(opts.n_iter):
                b = opts.n_samples
                status_cb("encoding prompt")
                cond = self.bundle.conditioner.encode(opts.prompt)
                txt = cond["txt"].to(self.device)[None].expand(
                    (b,) + tuple(cond["txt"].shape))
                vec = cond["vec"].to(self.device)[None].expand(b, -1)
                src = noise(base_seed + img_index, self.device)
                h, w = opts.H // 8, opts.W // 8
                t0 = time.perf_counter()
                x = pack_latents(src.initial((b, h, w, 16)))
                out = self.sample(opts, x, txt, vec, h // 2, w // 2, status_cb)
                lat = unpack_latents(out, h, w)
                status_cb("decoding")
                imgs = device_to_img01(decode_from_latent(
                    self.bundle.vae, lat.to(torch.bfloat16)))
                logger.info("sampling+decode took %.2fs",
                            time.perf_counter() - t0)
                if opts.safety_check:
                    imgs, _ = self.safety.check(imgs)
                for i in range(b):
                    img = embed_watermark(imgs[i]) if opts.watermark else imgs[i]
                    meta = dataclasses.asdict(opts)
                    meta["seed"] = base_seed + img_index
                    meta.pop("extra", None)
                    results.append((img, meta))
                    if result_cb is not None:
                        result_cb(img, meta)
                    img_index += 1
        return results
