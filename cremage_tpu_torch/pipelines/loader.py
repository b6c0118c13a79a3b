"""Checkpoint files -> SD15Bundle / SDXLBundle (the port of
cremage_tpu/pipelines/loader.py `load_sd15_bundle` and `load_sdxl_bundle`),
with the reference's overlay order: base -> VAE -> LoRA, and (SD1.5) a
ControlNet beside. The SDXL refiner, inpainting and 8-bit branches are not
ported yet.

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
from cremage_tpu_torch.models.open_clip import (
    OpenCLIPTextModel, openclip_bigg_config,
)
from cremage_tpu_torch.models.unet import (
    UNetConfig, UNetModel, sd15_unet_config, sdxl_base_unet_config,
)
from cremage_tpu_torch.models.vae import AutoencoderKL, VAEConfig, sdxl_vae_config
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.pipelines.sd15 import SD15Bundle
from cremage_tpu_torch.pipelines.sdxl import SDXLBundle, SDXLConditioner
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import schedules as S

logger = logging.getLogger(__name__)


def _on_meta(cls, cfg, dtype):
    with torch.device("meta"):
        return set_compute_dtype(cls(cfg), dtype)


class _Loads:
    """Reads files and fills modules on `device`, keeping each file's bytes
    and load seconds in report["files"]."""

    def __init__(self, device: torch.device):
        self.device = device
        self.report: Dict = {"files": {}, "loras": []}

    def read(self, path: str) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        sd = CK.load_state_dict(path)
        self.report["files"][path] = dict(
            bytes=sum(t.numel() * t.element_size() for t in sd.values()),
            seconds=time.perf_counter() - t0)
        return sd

    def fill(self, module, sd, path, what):
        """Load `sd` (from `path`) into `module`; the file is mapped, so
        its bytes are read here, and the time counts to the file."""
        t0 = time.perf_counter()
        CK.load_into(module, sd, self.device, f"{what} of {path}")
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.report["files"][path]["seconds"] += time.perf_counter() - t0
        return module.eval()

    def vae(self, ckpt: str, vae_sd, vae_ckpt: Optional[str]):
        """(path, state dict) of the VAE: the checkpoint's keys, a
        standalone file's overlaid on them, as in JAX."""
        if not vae_ckpt:
            return ckpt, vae_sd
        return vae_ckpt, {**vae_sd, **CK.component_state_dict(
            CK.vae_state_dict_from_standalone(self.read(vae_ckpt)),
            CK.PREFIX_VAE)}

    def merge_loras(self, loras, unet, clip, unet_cfg, text2=None):
        names: List[str] = []
        for path, weight in loras:
            merged, skipped, got = merge_lora(unet, clip, self.read(path),
                                              weight, unet_cfg, text2)
            names += got
            self.report["loras"].append(dict(path=path, merged=merged,
                                             skipped=skipped))
            logger.info("LoRA %s: merged %d modules, skipped %d", path,
                        merged, skipped)
        self.report["lora_modules"] = names


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
    loads = _Loads(device)
    read, fill = loads.read, loads.fill

    unet_cfg = unet_cfg or sd15_unet_config(dtype=dtype)
    unet_cfg = dataclasses.replace(unet_cfg, dtype=dtype,
                                   in_channels=9 if inpainting else
                                   unet_cfg.in_channels)
    vae_cfg = dataclasses.replace(vae_cfg or VAEConfig(), dtype=dtype)
    clip_cfg = dataclasses.replace(clip_cfg or CLIPTextConfig(), dtype=dtype)

    parts = CK.split_sd15(read(ckpt))
    vae_path, vae_sd = loads.vae(ckpt, parts.pop(CK.PREFIX_VAE), vae_ckpt)
    unet = fill(_on_meta(UNetModel, unet_cfg, dtype),
                parts.pop(CK.PREFIX_UNET), ckpt, "UNet")
    clip = fill(_on_meta(CLIPTextModel, clip_cfg, dtype),
                parts.pop(CK.PREFIX_CLIP_SD15), ckpt, "CLIP")
    vae = fill(_on_meta(AutoencoderKL, vae_cfg, dtype), vae_sd, vae_path, "VAE")
    del parts, vae_sd

    loads.merge_loras(loras, unet, clip, unet_cfg)

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
                      load_report=loads.report)


def load_sdxl_bundle(ckpt: str, vae_ckpt: Optional[str] = None,
                     loras: Sequence[Tuple[str, float]] = (),
                     embedding_dir: Optional[str] = None,
                     device=None, dtype: torch.dtype = torch.bfloat16
                     ) -> SDXLBundle:
    """An SDXL base bundle on `device` (CUDA unless named) in `dtype` from
    a single-file checkpoint (the sgm key layout), an optional standalone
    VAE, (path, weight) LoRAs (UNet, te1 -> CLIP-L, te2 -> OpenCLIP bigG)
    and a TI directory (two-tower files give each tower its entry), at
    the published configs; `load_report` as in load_sd15_bundle."""
    device = resolve_device(device)
    loads = _Loads(device)
    unet_cfg = dataclasses.replace(sdxl_base_unet_config(), dtype=dtype)
    vae_cfg = dataclasses.replace(sdxl_vae_config(), dtype=dtype)
    clip_cfg = dataclasses.replace(CLIPTextConfig(), dtype=dtype)
    openclip_cfg = dataclasses.replace(openclip_bigg_config(), dtype=dtype)

    parts = CK.split_sdxl(loads.read(ckpt))
    vae_path, vae_sd = loads.vae(ckpt, parts.pop(CK.PREFIX_VAE), vae_ckpt)
    unet = loads.fill(_on_meta(UNetModel, unet_cfg, dtype),
                      parts.pop(CK.PREFIX_UNET), ckpt, "UNet")
    clip = loads.fill(_on_meta(CLIPTextModel, clip_cfg, dtype),
                      parts.pop(CK.PREFIX_CLIP_SDXL), ckpt, "CLIP-L")
    oc = loads.fill(_on_meta(OpenCLIPTextModel, openclip_cfg, dtype),
                    parts.pop(CK.PREFIX_OPENCLIP_SDXL), ckpt, "OpenCLIP")
    vae = loads.fill(_on_meta(AutoencoderKL, vae_cfg, dtype), vae_sd,
                     vae_path, "VAE")
    del parts, vae_sd
    loads.merge_loras(loras, unet, clip, unet_cfg, text2=oc)
    cond = SDXLConditioner(clip, oc, default_tokenizer(), embedding_dir)
    return SDXLBundle(unet=unet, conditioner=cond, vae=vae,
                      load_report=loads.report)
