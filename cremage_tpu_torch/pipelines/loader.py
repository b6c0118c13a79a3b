"""Checkpoint files -> SD15Bundle (the port of cremage_tpu/pipelines/loader.py
`load_sd15_bundle`), with the reference's overlay order: base -> VAE ->
LoRA, and a ControlNet beside.

Each component is built on the meta device and filled from the file
strictly (io/checkpoint.py `load_into`), every tensor converted to its
parameter's dtype on the way to the device, so the host holds no converted
copy of the weights (the file itself is memory-mapped). LoRAs merge on the
device in float32 and are cast back (io/lora.py). The JAX package's
FaceID and 8-bit branches are not ported yet; its on-disk params cache
saves its torch -> JAX conversion, which the port does not have, so there
is none here.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cremage_tpu_torch.core.rng import resolve_device
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io.lora import merge_lora
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.controlnet import PREFIX_CONTROLNET, ControlNet
from cremage_tpu_torch.models.layers import set_compute_dtype
from cremage_tpu_torch.models.unet import UNetConfig, UNetModel, sd15_unet_config
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.pipelines.sd15 import SD15Bundle
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import schedules as S

logger = logging.getLogger(__name__)


def _on_meta(cls, cfg, dtype):
    with torch.device("meta"):
        return set_compute_dtype(cls(cfg), dtype)


def load_sd15_bundle(ckpt: str, vae_ckpt: Optional[str] = None,
                     loras: Sequence[Tuple[str, float]] = (),
                     embedding_dir: Optional[str] = None,
                     inpainting: bool = False,
                     control_ckpt: Optional[str] = None,
                     device=None, dtype: torch.dtype = torch.bfloat16,
                     unet_cfg: Optional[UNetConfig] = None,
                     vae_cfg: Optional[VAEConfig] = None,
                     clip_cfg: Optional[CLIPTextConfig] = None) -> SD15Bundle:
    """An SD1.5 bundle on `device` (CUDA unless named) from a single-file
    checkpoint, an optional standalone VAE, (path, weight) LoRAs, a TI
    directory and an optional ControlNet file. `inpainting` gives the UNet
    the 9 input channels of the inpainting checkpoints. The cfg arguments
    load non-standard (tiny test) checkpoints. The bundle's `load_report`
    holds each file's bytes and load seconds ("files"), each LoRA's merge
    counts ("loras") and the names of the merged modules
    ("lora_modules")."""
    device = resolve_device(device)
    report: Dict = {"files": {}, "loras": []}
    files: Dict[str, dict] = report["files"]

    def read(path: str) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        sd = CK.load_state_dict(path)
        files[path] = dict(bytes=sum(t.numel() * t.element_size()
                                     for t in sd.values()),
                           seconds=time.perf_counter() - t0)
        return sd

    def fill(module, sd, path, what):
        """Load `sd` (from `path`) into `module`; the file is mapped, so
        its bytes are read here, and the time counts to the file."""
        t0 = time.perf_counter()
        CK.load_into(module, sd, device, f"{what} of {path}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        files[path]["seconds"] += time.perf_counter() - t0
        return module.eval()

    unet_cfg = unet_cfg or sd15_unet_config(dtype=dtype)
    unet_cfg = dataclasses.replace(unet_cfg, dtype=dtype,
                                   in_channels=9 if inpainting else
                                   unet_cfg.in_channels)
    vae_cfg = dataclasses.replace(vae_cfg or VAEConfig(), dtype=dtype)
    clip_cfg = dataclasses.replace(clip_cfg or CLIPTextConfig(), dtype=dtype)

    parts = CK.split_sd15(read(ckpt))
    vae_path, vae_sd = ckpt, parts.pop(CK.PREFIX_VAE)
    if vae_ckpt:    # overlaid on the checkpoint's VAE keys, as in JAX
        vae_path, vae_sd = vae_ckpt, {**vae_sd, **CK.component_state_dict(
            CK.vae_state_dict_from_standalone(read(vae_ckpt)), CK.PREFIX_VAE)}
    unet = fill(_on_meta(UNetModel, unet_cfg, dtype),
                parts.pop(CK.PREFIX_UNET), ckpt, "UNet")
    clip = fill(_on_meta(CLIPTextModel, clip_cfg, dtype),
                parts.pop(CK.PREFIX_CLIP_SD15), ckpt, "CLIP")
    vae = fill(_on_meta(AutoencoderKL, vae_cfg, dtype), vae_sd, vae_path, "VAE")
    del parts, vae_sd

    lora_names: List[str] = []
    for path, weight in loras:
        merged, skipped, names = merge_lora(unet, clip, read(path), weight,
                                            unet_cfg)
        lora_names += names
        report["loras"].append(dict(path=path, merged=merged, skipped=skipped))
        logger.info("LoRA %s: merged %d modules, skipped %d", path, merged,
                    skipped)
    report["lora_modules"] = lora_names

    controlnet = None
    if control_ckpt:
        # the ControlNet sees the 4 latent channels even beside the
        # 9-channel inpainting UNet
        cn_cfg = dataclasses.replace(unet_cfg, in_channels=unet_cfg.out_channels)
        controlnet = fill(
            _on_meta(ControlNet, cn_cfg, dtype),
            CK.component_state_dict(read(control_ckpt), PREFIX_CONTROLNET),
            control_ckpt, "ControlNet")
    return SD15Bundle(unet=unet, vae=vae,
                      text=TextEncoder(clip, default_tokenizer(), embedding_dir),
                      schedule=S.default_sd_schedule(), controlnet=controlnet,
                      load_report=report)
