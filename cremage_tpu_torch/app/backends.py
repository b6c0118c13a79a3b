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

`sdxl_factory(prefs)` is the factory of the "SDXL" model type: the base
checkpoint from `opts.ckpt` or sdxl_ldm_model_path / sdxl_ldm_model, with
the job's standalone VAE, LoRAs (UNet, te1, te2) and TI directory (the
job's, else sdxl_embedding_path). Pass both factories one
`ResidentInstance` and one model of either family stays resident. The
refiner, inpainting, 8-bit storage and auto face fix are not ported yet
(the pipeline refuses them).
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
        ckpt = opts.ckpt or _model_path(prefs, "sdxl_ldm_model_path",
                                        "sdxl_ldm_model")
        loras = parse_lora_option_string(opts.lora_models, opts.lora_weights)
        embedding_dir = (opts.embedding_path or prefs.sdxl_embedding_path
                         or None)
        key = ("sdxl", ckpt, opts.vae_ckpt or None, tuple(loras),
               embedding_dir)
        return resident.get(key, lambda: SDXLPipeline(load_sdxl_bundle(
            ckpt, vae_ckpt=opts.vae_ckpt or None, loras=loras,
            embedding_dir=embedding_dir, device=device), device=device))

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
    from cremage_tpu_torch.pipelines.sd15 import SD15Pipeline

    resident = resident or ResidentInstance()

    def pipe_for(opts: GenerationOptions):
        inpaint = opts.mode == MODE_INPAINTING
        ckpt = opts.ckpt or _model_path(
            prefs, "ldm_model_path",
            "ldm_inpaint_model" if inpaint else "ldm_model")
        loras = parse_lora_option_string(opts.lora_models, opts.lora_weights)
        embedding_dir = opts.embedding_path or prefs.embedding_path or None
        key = ("sd15", ckpt, opts.vae_ckpt or None, tuple(loras),
               embedding_dir, inpaint, opts.control_net or None)
        return resident.get(key, lambda: SD15Pipeline(load_sd15_bundle(
            ckpt, vae_ckpt=opts.vae_ckpt or None, loras=loras,
            embedding_dir=embedding_dir, inpainting=inpaint,
            control_ckpt=opts.control_net or None, device=device),
            device=device))

    def factory():
        def generate(params, status_cb, result_cb):
            opts = GenerationOptions.from_dict(params)
            pipe_for(opts).generate(
                opts, status_cb=status_cb, result_cb=result_cb,
                init_image=load_image(params, "init_img"),
                mask_image=load_image(params, "mask_img"),
                control_image=load_image(params, "control_image_path"))
        generate.resident = resident
        return generate

    return factory
