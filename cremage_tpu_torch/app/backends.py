"""The SD1.5 and SDXL backends from checkpoint files (the port of the
SD1.5 and SDXL parts of cremage_tpu/app/backends.py).

`sd15_factory(prefs)` is the worker factory of the "SD 1.5" model type:
each job's parameters become GenerationOptions; its bundle comes from
`opts.ckpt` or the preferences' model (the inpainting model for mode
"inpainting"), with the job's standalone VAE, LoRAs, TI directory and
ControlNet; one bundle stays resident (`ResidentInstance`) and a job that
needs another one replaces it. Images named by `init_img`, `mask_img` and
`control_image_path` are read with the port's PNG reader. FaceID, auto
face fix and the speed features are not ported yet (the pipeline refuses
them).

`sdxl_factory(prefs)` is the factory of the "SDXL" model type: the
checkpoint from `opts.ckpt` or sdxl_ldm_model_path / sdxl_ldm_model (for
mode "inpainting" with sdxl_ldm_inpaint_model set, that 9-channel model;
without it the base model inpaints), with the job's standalone VAE,
refiner (`refiner_ckpt`), LoRAs (UNet, te1, te2) and TI directory (the
job's, else sdxl_embedding_path). Pass both factories one
`ResidentInstance` and one model of either family stays resident. Auto
face fix is not ported yet (the pipeline refuses it). Both read
`unet_quantize` ("float8_e4m3", "float8_e5m2"; "int8" is refused) as the
JAX backends do: 8-bit storage of the UNets' linear weights.

`flux_factory(prefs)` is the factory of the "FLUX.1-schnell" model type:
the job names the four files (`ckpt`: the BFL transformer, `vae_ckpt`,
`clip_ckpt`, `t5_ckpt`) and `flux_quantize` ("float8_e4m3" by default,
"float8_e5m2", "int8", "none"), as in the JAX backend. Like it, the
factory passes no T5 tokenizer, so the T5 context of a served request is
zeros whatever the files (pipelines/flux.py `FluxConditioner`).

`svd_factory(prefs)` is the factory of the "SVD" model type (img2vid):
JAX's parameters (`init_img`; `ckpt`, or `svd_model` under
svd_model_path; num_frames, sampling_steps, fps_id, motion_bucket_id,
cond_aug, seed, unet_quantize), JAX's resident key and errors, one result
per frame with {"frame": i, **the job's scalar parameters}. FILM
interpolation is not ported: a non-zero `interpolation_frames` raises.
`make_mp4` and `output_mp4` act only after FILM passes in JAX, so with
none they are ignored and the frames served, as there.

`sd3_factory(prefs)` ("SD 3") and `pixart_factory(prefs)` ("PixArt-Sigma")
load their bundle from `opts.ckpt` or the preferences' sd3_ldm_model /
pixart_sigma_ldm_model with JAX's parameters: SD3's `include_t5` (default
True), `sd3_quantize_t5` and `dit_quantize`, PixArt's `vae_ckpt` and
`dit_quantize`, and JAX's resident keys. Neither passes a T5 tokenizer,
as in JAX, so both condition on a zero T5 context.

`hunyuan_factory(prefs)` ("Hunyuan DiT") loads its bundle from the
component files the job names, as JAX's backend picks them: `ckpt` or
`dit_ckpt` (the diffusers transformer), `vae_ckpt`, `clip_ckpt` +
`clip_vocab` (the BERT branch), `mt5_ckpt` + `mt5_spiece` (the mT5
branch), each else the standard file name under `hunyuan_dir`
(transformer.safetensors, vae.safetensors, clip.safetensors, vocab.txt,
mt5.safetensors, spiece.model) where it exists; `dit_quantize`; JAX's
resident key and its error when no transformer is found.

`kandinsky_factory(prefs)` ("Kandinsky 2.2") loads its bundle from the
four component files the job names, as JAX's backend picks them:
`prior_ckpt`, `decoder_ckpt`, `text_encoder_ckpt` and `movq_ckpt`, each
else the standard name under `kandinsky_dir` (prior.safetensors,
decoder.safetensors, text_encoder.safetensors, movq.safetensors) where it
exists; JAX's resident key and its error when the prior, the decoder or
the text tower is not found (the loader refuses a missing MoVQ file).
Jobs may name `init_img` and `mask_img` for inpainting.
"""
from __future__ import annotations

import gc
import logging
import os
from typing import Callable, Optional

from cremage_tpu_torch.app.server import load_image
from cremage_tpu_torch.core.config import GenerationOptions, MODE_INPAINTING, Preferences

logger = logging.getLogger(__name__)


def _model_path(prefs: Preferences, path_attr: str, name_attr: str) -> str:
    name = getattr(prefs, name_attr)
    if not name or name == "None":
        raise FileNotFoundError(
            f"preferences.{name_attr} is not set; configure a model file")
    return os.path.join(getattr(prefs, path_attr), name)


class ResidentInstance:
    """One resident pipeline, keyed on every load-relevant option: the same
    key reuses it, another key drops it (and empties the CUDA cache)
    before building the next one."""

    def __init__(self):
        self.key: Optional[tuple] = None
        self.instance = None

    def get(self, key: tuple, build: Callable):
        if self.key == key and self.instance is not None:
            return self.instance
        if self.instance is not None:
            logger.info("evicting resident model instance %s", self.key[:2])
            self.key = self.instance = None
            gc.collect()
            import torch

            if torch.cuda.is_available():
                torch.cuda.empty_cache()
        inst = build()
        self.key, self.instance = key, inst
        return inst


def sdxl_factory(prefs: Preferences, device=None,
                 resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb) for SDXL
    base jobs, loading the bundle from the files the job and `prefs`
    name."""
    from cremage_tpu_torch.io.lora import parse_lora_option_string
    from cremage_tpu_torch.pipelines.loader import load_sdxl_bundle
    from cremage_tpu_torch.pipelines.sdxl import SDXLPipeline, check_supported

    resident = resident or ResidentInstance()

    def pipe_for(opts: GenerationOptions):
        inpaint = (opts.mode == MODE_INPAINTING
                   and prefs.sdxl_ldm_inpaint_model not in ("", "None"))
        ckpt = opts.ckpt or _model_path(
            prefs, "sdxl_ldm_model_path",
            "sdxl_ldm_inpaint_model" if inpaint else "sdxl_ldm_model")
        loras = parse_lora_option_string(opts.lora_models, opts.lora_weights)
        embedding_dir = (opts.embedding_path or prefs.sdxl_embedding_path
                         or None)
        refiner = opts.refiner_ckpt or None
        quantize = opts.extra.get("unet_quantize") or None
        key = ("sdxl", ckpt, opts.vae_ckpt or None, refiner, tuple(loras),
               embedding_dir, inpaint, quantize)
        return resident.get(key, lambda: SDXLPipeline(load_sdxl_bundle(
            ckpt, vae_ckpt=opts.vae_ckpt or None, refiner_ckpt=refiner,
            loras=loras, embedding_dir=embedding_dir, inpainting=inpaint,
            device=device, quantize_unet=quantize), device=device))

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            check_supported(opts)       # before a model is loaded for it
            pipe_for(opts).generate(
                opts, status_cb=status_cb, result_cb=result_cb,
                init_image=load_image(params, "init_img"),
                mask_image=load_image(params, "mask_img"))
        generate.resident = resident
        return generate

    return factory


def sd15_factory(prefs: Preferences, device=None,
                 resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb), loading the
    bundle of each job from the files the job and `prefs` name."""
    from cremage_tpu_torch.io.lora import parse_lora_option_string
    from cremage_tpu_torch.pipelines.loader import load_sd15_bundle
    from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline, check_supported

    resident = resident or ResidentInstance()

    def pipe_for(opts: GenerationOptions):
        inpaint = opts.mode == MODE_INPAINTING
        ckpt = opts.ckpt or _model_path(
            prefs, "ldm_model_path",
            "ldm_inpaint_model" if inpaint else "ldm_model")
        loras = parse_lora_option_string(opts.lora_models, opts.lora_weights)
        embedding_dir = opts.embedding_path or prefs.embedding_path or None
        quantize = opts.extra.get("unet_quantize") or None
        key = ("sd15", ckpt, opts.vae_ckpt or None, tuple(loras),
               embedding_dir, inpaint, opts.control_net or None, quantize)
        return resident.get(key, lambda: SD15Pipeline(load_sd15_bundle(
            ckpt, vae_ckpt=opts.vae_ckpt or None, loras=loras,
            embedding_dir=embedding_dir, inpainting=inpaint,
            control_ckpt=opts.control_net or None, device=device,
            quantize_unet=quantize), device=device))

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            check_supported(opts)       # before a model is loaded for it
            pipe_for(opts).generate(
                opts, status_cb=status_cb, result_cb=result_cb,
                init_image=load_image(params, "init_img"),
                mask_image=load_image(params, "mask_img"),
                control_image=load_image(params, "control_image_path"))
        generate.resident = resident
        return generate

    return factory


def flux_factory(prefs: Preferences, device=None,
                 resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb) for FLUX.1
    jobs, loading the bundle from the files the job names; the resident
    key is JAX's (the files and flux_quantize)."""
    from cremage_tpu_torch.pipelines.flux import FluxPipeline, check_supported
    from cremage_tpu_torch.pipelines.loader import load_flux_bundle

    resident = resident or ResidentInstance()

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            if not opts.ckpt or not os.path.exists(opts.ckpt):
                raise FileNotFoundError(
                    "FLUX needs local weight files: pass 'ckpt' (the BFL "
                    "transformer .safetensors) plus vae_ckpt, clip_ckpt and "
                    "t5_ckpt")
            check_supported(opts)       # before a model is loaded for it
            quantize = params.get("flux_quantize", "float8_e4m3")
            key = ("flux", opts.ckpt, opts.vae_ckpt, params.get("clip_ckpt"),
                   params.get("t5_ckpt"), quantize)
            pipe = resident.get(key, lambda: FluxPipeline(load_flux_bundle(
                opts.ckpt, vae_ckpt=opts.vae_ckpt,
                clip_ckpt=params.get("clip_ckpt"),
                t5_ckpt=params.get("t5_ckpt"), quantize=quantize,
                device=device), device=device))
            pipe.generate(opts, status_cb=status_cb, result_cb=result_cb)
        generate.resident = resident
        return generate

    return factory


def svd_factory(prefs: Preferences, device=None,
                resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb) for SVD
    img2vid jobs, loading the bundle from the file the job names."""
    from cremage_tpu_torch.pipelines.loader import load_svd_bundle
    from cremage_tpu_torch.pipelines.svd import (
        SVDOptions, SVDPipeline, check_supported,
    )

    resident = resident or ResidentInstance()

    def factory():
        def generate(params, status_cb, result_cb):
            init = load_image(params, "init_img")
            if init is None:
                raise FileNotFoundError("SVD requires init_img")
            ckpt = params.get("ckpt")
            if not ckpt and params.get("svd_model"):
                ckpt = os.path.join(prefs.svd_model_path, params["svd_model"])
            if not ckpt:
                raise FileNotFoundError(
                    "SVD checkpoint path not provided (ckpt or svd_model)")
            opts = SVDOptions(
                num_frames=int(params.get("num_frames", 14)),
                num_steps=int(params.get("sampling_steps", 25)),
                fps_id=int(params.get("fps_id", 6)),
                motion_bucket_id=int(params.get("motion_bucket_id", 127)),
                cond_aug=float(params.get("cond_aug", 0.02)),
                seed=int(params.get("seed", -1)),
                deep_cache=int(params.get("deep_cache", 1)),
                deep_cache_branch=int(params.get("deep_cache_branch", 1)),
                tome_ratio=float(params.get("tome_ratio", 0.0)),
                ada_cache=float(params.get("ada_cache", 0.0)))
            # as in JAX, make_mp4 and output_mp4 act only after FILM passes
            passes = int(params.get("interpolation_frames", 0))
            if passes:
                raise NotImplementedError(
                    f"FILM interpolation and the mp4 writer are not ported "
                    f"(ROADMAP.md, M15b: they need cv2): interpolation_frames "
                    f"{passes}")
            check_supported(opts)       # before a model is loaded for it
            quantize = params.get("unet_quantize") or None
            pipe = resident.get(
                ("svd", ckpt, opts.num_frames, quantize),
                lambda: SVDPipeline(load_svd_bundle(
                    ckpt, num_frames=opts.num_frames, quantize_unet=quantize,
                    device=device), device=device))
            frames = pipe.sample((init + 1) / 2, opts, status_cb=status_cb,
                                 output_dir=params.get("outdir"))
            meta = {k: v for k, v in params.items()
                    if isinstance(v, (int, float, str))}
            for i, f in enumerate(frames):
                result_cb(f, {"frame": i, **meta})
        generate.resident = resident
        return generate

    return factory


def sd3_factory(prefs: Preferences, device=None,
                resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb) for SD3
    txt2img jobs, loading the bundle from the one file the job or `prefs`
    names."""
    from cremage_tpu_torch.pipelines.loader import load_sd3_bundle
    from cremage_tpu_torch.pipelines.sd3 import SD3Pipeline, check_supported

    resident = resident or ResidentInstance()

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            check_supported(opts)       # before a model is loaded for it
            ckpt = opts.ckpt or _model_path(prefs, "sd3_ldm_model_path",
                                            "sd3_ldm_model")
            include_t5 = params.get("include_t5", True)
            quantize_t5 = params.get("sd3_quantize_t5")
            quantize_dit = params.get("dit_quantize") or None
            pipe = resident.get(
                ("sd3", ckpt, include_t5, quantize_t5, quantize_dit),
                lambda: SD3Pipeline(load_sd3_bundle(
                    ckpt, include_t5=include_t5, quantize_t5=quantize_t5,
                    quantize_dit=quantize_dit, device=device), device=device))
            pipe.generate(opts, status_cb=status_cb, result_cb=result_cb)
        generate.resident = resident
        return generate

    return factory


def pixart_factory(prefs: Preferences, device=None,
                   resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb) for PixArt-Σ
    txt2img jobs, loading the bundle from the transformer file the job or
    `prefs` names and the job's `vae_ckpt`."""
    from cremage_tpu_torch.pipelines.loader import load_pixart_bundle
    from cremage_tpu_torch.pipelines.pixart import PixArtPipeline
    from cremage_tpu_torch.pipelines.sd3 import check_supported

    resident = resident or ResidentInstance()

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            check_supported(opts)       # before a model is loaded for it
            ckpt = opts.ckpt or _model_path(
                prefs, "pixart_sigma_ldm_model_path", "pixart_sigma_ldm_model")
            quantize = params.get("dit_quantize") or None
            pipe = resident.get(
                ("pixart", ckpt, opts.vae_ckpt or None, quantize),
                lambda: PixArtPipeline(load_pixart_bundle(
                    ckpt, vae_ckpt=opts.vae_ckpt or None,
                    quantize_dit=quantize, device=device), device=device))
            pipe.generate(opts, status_cb=status_cb, result_cb=result_cb)
        generate.resident = resident
        return generate

    return factory


HUNYUAN_FILES = (("dit_ckpt", "transformer.safetensors"),
                 ("vae_ckpt", "vae.safetensors"),
                 ("clip_ckpt", "clip.safetensors"), ("clip_vocab", "vocab.txt"),
                 ("mt5_ckpt", "mt5.safetensors"), ("mt5_spiece", "spiece.model"))


def component_files(params: dict, dir_key: str, files) -> dict:
    """{option: path or None} of a job's component files (`files`: (option,
    standard name) pairs), as JAX's backends pick them: each option's own
    path, else the standard name under the job's `dir_key` directory where
    that file exists."""
    base = params.get(dir_key)

    def pick(key, name):
        cand = os.path.join(base, name) if base else None
        return params.get(key) or (cand if cand and os.path.exists(cand)
                                   else None)

    return {key: pick(key, name) for key, name in files}


def hunyuan_files(params: dict) -> dict:
    """`component_files` of a Hunyuan-DiT job under `hunyuan_dir`, the
    job's `ckpt` before `dit_ckpt`."""
    out = component_files(params, "hunyuan_dir", HUNYUAN_FILES)
    out["dit_ckpt"] = params.get("ckpt") or out["dit_ckpt"]
    return out


def hunyuan_factory(prefs: Preferences, device=None,
                    resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb) for
    Hunyuan-DiT txt2img jobs, loading the bundle from the component files
    the job names (`hunyuan_files`)."""
    from cremage_tpu_torch.pipelines.hunyuan import HunyuanPipeline
    from cremage_tpu_torch.pipelines.loader import load_hunyuan_bundle
    from cremage_tpu_torch.pipelines.sd3 import check_supported

    resident = resident or ResidentInstance()

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            f = hunyuan_files(params)
            if not f["dit_ckpt"]:
                raise FileNotFoundError(
                    "Hunyuan-DiT needs the diffusers component files: "
                    "pass ckpt/dit_ckpt (+ vae_ckpt, clip_ckpt + "
                    "clip_vocab for the BertModel branch, mt5_ckpt + "
                    "mt5_spiece for the mT5 branch), or hunyuan_dir "
                    "with transformer/vae/clip/mt5.safetensors + "
                    "vocab.txt + spiece.model "
                    "(Tencent-Hunyuan/HunyuanDiT-Diffusers)")
            check_supported(opts)       # before a model is loaded for it
            quantize = params.get("dit_quantize") or None
            key = ("hunyuan",) + tuple(f[k] for k, _ in HUNYUAN_FILES) + (
                quantize,)
            pipe = resident.get(key, lambda: HunyuanPipeline(load_hunyuan_bundle(
                f["dit_ckpt"], vae_ckpt=f["vae_ckpt"], clip_ckpt=f["clip_ckpt"],
                clip_vocab=f["clip_vocab"], mt5_ckpt=f["mt5_ckpt"],
                mt5_tokenize=f["mt5_spiece"], quantize_dit=quantize,
                device=device), device=device))
            pipe.generate(opts, status_cb=status_cb, result_cb=result_cb)
        generate.resident = resident
        return generate

    return factory


KANDINSKY_FILES = (("prior_ckpt", "prior.safetensors"),
                   ("decoder_ckpt", "decoder.safetensors"),
                   ("text_encoder_ckpt", "text_encoder.safetensors"),
                   ("movq_ckpt", "movq.safetensors"))


def kandinsky_factory(prefs: Preferences, device=None,
                      resident: Optional[ResidentInstance] = None) -> Callable:
    """-> factory() -> generate(params, status_cb, result_cb) for Kandinsky
    2.2 txt2img and inpainting jobs, loading the bundle from the component
    files the job names (`component_files` under `kandinsky_dir`)."""
    from cremage_tpu_torch.pipelines.kandinsky import KandinskyPipeline
    from cremage_tpu_torch.pipelines.loader import load_kandinsky_bundle
    from cremage_tpu_torch.pipelines.sd3 import check_supported

    resident = resident or ResidentInstance()

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            f = component_files(params, "kandinsky_dir", KANDINSKY_FILES)
            if not (f["prior_ckpt"] and f["decoder_ckpt"]
                    and f["text_encoder_ckpt"]):
                raise FileNotFoundError(
                    "Kandinsky 2.2 needs the diffusers component files: "
                    "pass prior_ckpt + decoder_ckpt + text_encoder_ckpt "
                    "(+ optional movq_ckpt), or kandinsky_dir containing "
                    "prior/decoder/text_encoder[/movq].safetensors "
                    "(kandinsky-community/kandinsky-2-2-{prior,decoder})")
            check_supported(opts)       # before a model is loaded for it
            key = ("kandinsky",) + tuple(f[k] for k, _ in KANDINSKY_FILES)
            pipe = resident.get(key, lambda: KandinskyPipeline(
                load_kandinsky_bundle(
                    f["prior_ckpt"], f["decoder_ckpt"], f["text_encoder_ckpt"],
                    movq_ckpt=f["movq_ckpt"], device=device), device=device))
            pipe.generate(opts, status_cb=status_cb, result_cb=result_cb,
                          init_image=load_image(params, "init_img"),
                          mask_image=load_image(params, "mask_img"))
        generate.resident = resident
        return generate

    return factory
