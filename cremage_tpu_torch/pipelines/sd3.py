"""SD3 txt2img pipeline (MMDiT + rectified flow) — the port of
cremage_tpu/pipelines/sd3.py.

Behavior contract (the JAX pipeline's):
- the conditioner: CLIP-L's and bigG's hidden state at index
  `num_layers - 1` of the prompt's first 77-token chunk (prompt weighting
  and TI through prompt/chunking.py, each tower its TI entry), CLIP-L's
  pooled output (the final-LayerNorm state at the chunk's EOS,
  unprojected) and bigG's projected pooled output; crossattn = [concat of
  the two hidden states zero-padded to T5's width; T5 over `t5_len` (77)
  tokens, or zeros of that shape without a T5 tower or tokenizer]
  -> (154, 4096), pooled (2048);
- per batch: the statuses "encoding prompt", "i / n" after each step and
  "decoding"; the initial noise is the batch's `NoiseSource.initial` at
  JAX's (B, H/8, W/8, 16) draw; flow Euler over the shift-3 sigmas with
  CFG over the batched [uc; c] velocity at t = sigma * 1000; the latent
  rounded to bf16 and decoded, uint8 on the device;
- the image safety check (flagged images swapped; the JAX SD3 pipeline
  writes no flag into the metadata), the watermark, seed = seed + i.

The speed features (deep_cache, ada_cache, tome_ratio), the guidance
interval and the sequence- and pipeline-parallel meshes are not ported:
`check_supported` and the mesh methods raise NotImplementedError. The
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
from cremage_tpu_torch.io.ti import load_embedding
from cremage_tpu_torch.models.clip import CLIPTextModel
from cremage_tpu_torch.models.mmdit import MMDiT
from cremage_tpu_torch.models.open_clip import OpenCLIPTextModel
from cremage_tpu_torch.models.t5 import T5Encoder
from cremage_tpu_torch.models.vae import AutoencoderKL, decode_from_latent
from cremage_tpu_torch.prompt.chunking import generate_weighted_chunks, make_ti_fetch
from cremage_tpu_torch.prompt.parser import compute_prompt_score
from cremage_tpu_torch.prompt.sentencepiece import as_t5_tokenize
from cremage_tpu_torch.prompt.tokenizer import CLIPTokenizer
from cremage_tpu_torch.samplers import flow as F
from cremage_tpu_torch.services.safety import ImageSafetyChecker, default_image_safety
from cremage_tpu_torch.services.watermark import embed_watermark
from cremage_tpu_torch.utils.image import device_to_img01

logger = logging.getLogger(__name__)

StatusCb = Callable[[str], None]
NoiseFactory = Callable[[int, torch.device], NoiseSource]


def _device(model) -> torch.device:
    return next(model.parameters()).device


def first_chunk(tokenizer: CLIPTokenizer, model, prompt: str,
                embedding_dir: Optional[str], tower_key: str):
    """The prompt's first weighted 77-token chunk for `model` (its TI
    entry `tower_key`) as a (1, 77, width) tensor on the model's device,
    and the chunk's EOS index."""
    dev = _device(model)

    def embed(ids):
        t = torch.as_tensor(np.asarray(ids, np.int64), device=dev)
        return model.embed_tokens(t).float().cpu().numpy()

    chunks, eos = generate_weighted_chunks(
        tokenizer, embed, compute_prompt_score(prompt),
        make_ti_fetch(embedding_dir, load_embedding, tower_key=tower_key))
    return torch.as_tensor(chunks[0][None], device=dev), eos[0]


class SD3Conditioner:
    """CLIP-L + bigG (+ optional T5) -> {"crossattn": (2 t5_len, 4096),
    "pooled": (2048,)}, float32 on CLIP-L's device."""

    def __init__(self, clip_l: CLIPTextModel, open_clip: OpenCLIPTextModel,
                 tokenizer: CLIPTokenizer, t5: Optional[T5Encoder] = None,
                 t5_tokenize=None, t5_len: int = 77, t5_dim: int = 4096,
                 embedding_dir: Optional[str] = None):
        self.clip_l = clip_l
        self.open_clip = open_clip
        self.tokenizer = tokenizer
        self.t5 = t5
        self.t5_tokenize = as_t5_tokenize(t5_tokenize, t5_len)
        self.t5_len = t5_len
        self.t5_dim = t5.cfg.d_model if t5 is not None else t5_dim
        self.embedding_dir = embedding_dir

    @torch.no_grad()
    def clip_parts(self, prompt: str):
        """-> (CLIP-L hidden (77, 768), its pooled (768), bigG hidden (77,
        1280), its projected pooled (1280)), float32."""
        ml, mg = self.clip_l, self.open_clip
        xl, eos_l = first_chunk(self.tokenizer, ml, prompt,
                                self.embedding_dir, "clip_l")
        last_l, hid_l = ml(xl)
        xg, eos_g = first_chunk(self.tokenizer, mg, prompt,
                                self.embedding_dir, "clip_g")
        hid_g, final_g = mg(xg)
        pooled_g = mg.project_pooled(final_g, torch.tensor([eos_g]))[0]
        return (hid_l[ml.cfg.num_layers - 1][0].float(), last_l[0, eos_l].float(),
                hid_g[mg.cfg.num_layers - 1][0].float(), pooled_g.float())

    @torch.no_grad()
    def encode(self, prompt: str) -> Dict[str, torch.Tensor]:
        zl, pooled_l, zg, pooled_g = self.clip_parts(prompt)
        dev = zl.device
        clip_cross = torch.cat([zl, zg.to(dev)], -1)
        clip_cross = torch.nn.functional.pad(
            clip_cross, (0, self.t5_dim - clip_cross.shape[-1]))
        if self.t5 is not None and self.t5_tokenize is not None:
            ids = np.asarray(self.t5_tokenize(prompt), np.int64)[: self.t5_len]
            ids = np.pad(ids, (0, self.t5_len - len(ids)))
            t5_out = self.t5(torch.from_numpy(ids[None]).to(_device(self.t5))
                             )[0].float().to(dev)
        else:
            t5_out = torch.zeros(self.t5_len, self.t5_dim, device=dev)
        return {"crossattn": torch.cat([clip_cross, t5_out], 0),
                "pooled": torch.cat([pooled_l, pooled_g.to(dev)], 0)}

    def encode_pair(self, opts: GenerationOptions, batch: int, device=None):
        """(c, uc) for a batch: dicts of float32 tensors on `device`."""
        def tile(d):
            return {k: v.to(device)[None].expand((batch,) + tuple(v.shape))
                    for k, v in d.items()}
        return (tile(self.encode(opts.prompt)),
                tile(self.encode(opts.negative_prompt)))


@dataclasses.dataclass
class SD3Bundle:
    mmdit: MMDiT
    conditioner: SD3Conditioner
    vae: AutoencoderKL
    shift: float = 3.0
    load_report: Optional[Dict] = None


def _noop_status(msg: str) -> None:
    pass


def check_supported(opts: GenerationOptions) -> None:
    """Raise NotImplementedError for every option the DiT ports do not run
    (the JAX pipelines run them all): the speed features and the guidance
    interval (ROADMAP M18)."""
    interval = (float(opts.cfg_interval_low), float(opts.cfg_interval_high))
    unsupported = {
        "deep_cache": (int(opts.deep_cache) >= 2, opts.deep_cache),
        "ada_cache": (float(opts.ada_cache) > 0.0, opts.ada_cache),
        "tome_ratio": (float(opts.tome_ratio) > 0.0, opts.tome_ratio),
        "cfg_interval": (interval[1] > interval[0], interval),
    }
    bad = {k: v for k, (on, v) in unsupported.items() if on}
    if bad:
        raise NotImplementedError(
            f"the PyTorch DiT pipelines run plain sampling; not ported: {bad}")


class NoMeshes:
    """The JAX DiT pipelines' mesh deployments, not ported (ROADMAP M19)."""

    def use_mesh_sp(self, *args, **kw):
        raise NotImplementedError("the sequence-parallel mesh is not ported")

    def use_mesh_pp(self, *args, **kw):
        raise NotImplementedError("the pipeline-parallel mesh is not ported")


class SD3Pipeline(NoMeshes):
    """`safety`: the image safety checker of jobs with safety_check on (by
    default `default_image_safety`, built at the first such job)."""

    def __init__(self, bundle: SD3Bundle, device=None,
                 safety: Optional[ImageSafetyChecker] = None):
        self.bundle = bundle
        self.device = resolve_device(device)
        self._safety = safety
        cond = bundle.conditioner
        for m in (bundle.mmdit, bundle.vae, cond.clip_l, cond.open_clip,
                  cond.t5):
            if m is not None:
                m.to(self.device).eval()

    @property
    def safety(self) -> ImageSafetyChecker:
        if self._safety is None:
            self._safety = default_image_safety(device=self.device)
        return self._safety

    def encode_pair(self, opts: GenerationOptions, batch: int):
        return self.bundle.conditioner.encode_pair(opts, batch, self.device)

    def sample(self, opts: GenerationOptions, x: torch.Tensor, c, uc,
               status_cb: StatusCb = _noop_status,
               noise: Optional[NoiseSource] = None) -> torch.Tensor:
        """Flow Euler with CFG from the noise x (B, h, w, 16) -> float32
        latents (deterministic: `noise` is not drawn from)."""
        mmdit = self.bundle.mmdit
        sigmas = F.sd3_sigmas(opts.sampling_steps, self.bundle.shift)

        def v_model(xx, tt, cond):
            return mmdit(xx, tt * 1000.0, cond["crossattn"], cond["pooled"])

        n = len(sigmas) - 1
        return F.sample_flow_euler(
            F.cfg_velocity(v_model, c, uc, float(opts.scale)), x, sigmas,
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
        return dit_generate(self, opts, status_cb, result_cb, noise, 16)


def dit_generate(pipe, opts: GenerationOptions, status_cb, result_cb,
                 noise: Optional[NoiseFactory], channels: int):
    """The batch loop the DiT pipelines share: conditioning
    (`pipe.bundle.conditioner.encode_pair` or `pipe.encode_pair`), the
    batch's noise source, `pipe.sample` from its (B, H/8, W/8, channels)
    initial noise, the bf16 decode, the safety check, the watermark and
    the metadata."""
    noise = noise or GeneratorNoise
    base_seed = resolve_seed(opts.seed)
    results = []
    img_index = 0
    with torch.no_grad():
        for _ in range(opts.n_iter):
            b = opts.n_samples
            status_cb("encoding prompt")
            c, uc = pipe.encode_pair(opts, b)
            src = noise(base_seed + img_index, pipe.device)
            t0 = time.perf_counter()
            x = src.initial((b, opts.H // 8, opts.W // 8, channels))
            lat = pipe.sample(opts, x, c, uc, status_cb, src)
            status_cb("decoding")
            imgs = device_to_img01(decode_from_latent(
                pipe.bundle.vae, lat.to(torch.bfloat16)))
            logger.info("sampling+decode took %.2fs", time.perf_counter() - t0)
            if opts.safety_check:
                imgs, _ = pipe.safety.check(imgs)
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
