"""Checkpoint files -> SD15Bundle / SDXLBundle / FluxBundle / SVDBundle /
SD3Bundle / PixArtBundle / HunyuanBundle / KandinskyBundle (the port of
cremage_tpu/pipelines/loader.py `load_sd15_bundle`, `load_sdxl_bundle`,
`load_flux_bundle`, `load_svd_bundle`, `load_sd3_bundle`,
`load_pixart_bundle`, `load_hunyuan_bundle` and `load_kandinsky_bundle`),
with the reference's overlay order: base -> VAE -> LoRA, and (SD1.5) a
ControlNet beside, (SDXL) the refiner's UNet and bigG beside. LoRAs merge
into the base model only, as in JAX; the refiner takes none.

Each component is built on the meta device and filled from the file
strictly (io/checkpoint.py `load_into`), every tensor converted to its
parameter's dtype on the way to the device, so the host holds no converted
copy of the weights (the file itself is memory-mapped). LoRAs merge on the
device in float32 and are cast back (io/lora.py). `quantize_unet`
stores the UNets' linear weights in 8 bits (io/quantize.py) after every
merge, from the weights in the model's dtype, as JAX quantizes its
parameters in their param dtype: as the file loads when no LoRA is
named, else in place after the merge. The JAX package's int8 storage of a UNet also
takes its convolutions (w8a8 convs), which have no PyTorch kernel on
CUDA: it is refused. The JAX package's FaceID branch is not ported yet;
its on-disk params cache saves its torch -> JAX conversion, which the
port does not have, so there is none here.
"""
from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from cremage_tpu_torch.core.rng import resolve_device
from cremage_tpu_torch.io import checkpoint as CK
from cremage_tpu_torch.io.lora import merge_lora
from cremage_tpu_torch.io.diffusers_keys import (
    hunyuan_from_diffusers, is_diffusers_vae, kandinsky_decoder_from_diffusers,
    kandinsky_prior_from_diffusers, movq_decoder_from_diffusers,
    pixart_from_diffusers, sd_vae_from_diffusers,
)
from cremage_tpu_torch.io.quantize import (
    MIN_SIZE, check_dtype, prepare_8bit, quantize_module, storage_report,
    unet_kind,
)
from cremage_tpu_torch.models.bert import BertModel, hunyuan_clip_config
from cremage_tpu_torch.models.clip import CLIPTextConfig, CLIPTextModel
from cremage_tpu_torch.models.clip_vision import CLIPVisionModel, vit_h14_config
from cremage_tpu_torch.models.controlnet import PREFIX_CONTROLNET, ControlNet
from cremage_tpu_torch.models.flux import FluxModel, flux_dev_config, flux_schnell_config
from cremage_tpu_torch.models.hunyuan import HunyuanDiT, hunyuan_dit_config
from cremage_tpu_torch.models.kandinsky import (
    DiffusionPrior, KandinskyImageConditioner, PriorConfig,
)
from cremage_tpu_torch.models.kandinsky_decoder import (
    KandinskyUNet, KandinskyUNetConfig,
)
from cremage_tpu_torch.models.layers import set_compute_dtype
from cremage_tpu_torch.models.mmdit import MMDiT, sd3_medium_config
from cremage_tpu_torch.models.open_clip import (
    OpenCLIPTextConfig, OpenCLIPTextModel, openclip_bigg_config,
)
from cremage_tpu_torch.models.pixart import PixArt, pixart_sigma_xl_config
from cremage_tpu_torch.models.unet import (
    UNetConfig, UNetModel, sd15_unet_config, sdxl_base_unet_config,
    sdxl_refiner_unet_config,
)
from cremage_tpu_torch.models.t5 import T5Encoder, mt5_xl_config, t5_xxl_config
from cremage_tpu_torch.models.vae import (
    AutoencoderKL, VAEConfig, flux_vae_config, sd3_vae_config, sdxl_vae_config,
)
from cremage_tpu_torch.models.video_unet import VideoUNet, svd_unet_config
from cremage_tpu_torch.models.vq import MoVQ, MoVQConfig
from cremage_tpu_torch.pipelines.conditioning import TextEncoder
from cremage_tpu_torch.pipelines.flux import FluxBundle, FluxConditioner
from cremage_tpu_torch.pipelines.hunyuan import HunyuanBundle, HunyuanTextEncoder
from cremage_tpu_torch.pipelines.kandinsky import KandinskyBundle, KandinskyTextEncoder
from cremage_tpu_torch.pipelines.pixart import PixArtBundle
from cremage_tpu_torch.pipelines.sd3 import SD3Bundle, SD3Conditioner
from cremage_tpu_torch.pipelines.sd15 import SD15Bundle
from cremage_tpu_torch.pipelines.sdxl import SDXLBundle, SDXLConditioner
from cremage_tpu_torch.pipelines.svd import SVDBundle
from cremage_tpu_torch.prompt.tokenizer import default_tokenizer
from cremage_tpu_torch.samplers import schedules as S

logger = logging.getLogger(__name__)


def _on_meta(cls, cfg, dtype, quantize: Optional[str] = None, **kw):
    """`cls(cfg)` on the meta device in `dtype`, the weights that
    io/quantize.py `targets` takes (`kw`: its min_size, include_convs) made
    8-bit if `quantize` names a kind (filled by `_Loads.fill`)."""
    with torch.device("meta"):
        module = set_compute_dtype(cls(cfg), dtype)
    if quantize:
        prepare_8bit(module, quantize, **kw)
    return module


def _dit_kind(quantize: Optional[str]) -> Optional[str]:
    """A DiT's or T5's 8-bit kind: None for None, "" and "none"."""
    return None if quantize in (None, "", "none") else check_dtype(quantize)


class _Loads:
    """Reads files and fills modules on `device` in `dtype`, keeping each
    file's bytes and load seconds in report["files"]."""

    def __init__(self, device: torch.device, dtype: torch.dtype):
        self.device, self.dtype = device, dtype
        self.report: Dict = {"files": {}, "loras": []}

    def read(self, path: str) -> Dict[str, torch.Tensor]:
        t0 = time.perf_counter()
        sd = CK.load_state_dict(path)
        self.report["files"][path] = dict(
            bytes=sum(t.numel() * t.element_size() for t in sd.values()),
            seconds=time.perf_counter() - t0)
        return sd

    def fill(self, module, sd, path, what, quantize: Optional[str] = None):
        """Load `sd` (from `path`) into `module`, quantizing its 8-bit
        weights (`_on_meta(..., quantize)`) as they load; the file is
        mapped, so its bytes are read here, and the time counts to the
        file."""
        t0 = time.perf_counter()
        CK.load_into(module, sd, self.device, f"{what} of {path}", quantize,
                     self.dtype)
        if quantize:
            self.report.setdefault("quantize", {})[what] = storage_report(
                module, quantize)
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

    def unet(self, cfg, sd, path, what, quantize, loras):
        """The UNet filled from `sd`, its linear weights in 8 bits if
        `quantize` names a kind: as they load, or, with `loras`, after the
        merge (`quantize_after_merge`)."""
        quantize = None if loras else quantize
        return self.fill(_on_meta(UNetModel, cfg, self.dtype, quantize),
                         sd, path, what, quantize)

    def quantize_after_merge(self, unet, what, quantize, loras):
        """The merged UNet's linear weights in 8 bits, quantized in place
        from the merged weights in the model's dtype, as JAX quantizes
        its merged parameters."""
        if quantize and loras:
            self.report.setdefault("quantize", {})[what] = quantize_module(
                unet, quantize)


def load_sd15_bundle(ckpt: str, vae_ckpt: Optional[str] = None,
                     loras: Sequence[Tuple[str, float]] = (),
                     embedding_dir: Optional[str] = None,
                     inpainting: bool = False,
                     control_ckpt: Optional[str] = None,
                     device=None, dtype: torch.dtype = torch.bfloat16,
                     unet_cfg: Optional[UNetConfig] = None,
                     vae_cfg: Optional[VAEConfig] = None,
                     clip_cfg: Optional[CLIPTextConfig] = None,
                     quantize_unet: Optional[str] = None) -> SD15Bundle:
    """An SD1.5 bundle on `device` (CUDA unless named) from a single-file
    checkpoint, an optional standalone VAE, (path, weight) LoRAs, a TI
    directory and an optional ControlNet file. `inpainting` gives the UNet
    the 9 input channels of the inpainting checkpoints. The cfg arguments
    load non-standard (tiny test) checkpoints. `quantize_unet`
    ("float8_e4m3", "float8_e5m2"; None or "none" for none) stores the
    UNet's linear weights of at least io/quantize.py `MIN_SIZE` elements
    in 8 bits. The bundle's `load_report` holds each file's bytes and load seconds
    ("files"), each LoRA's merge counts ("loras"), the names of the merged
    modules ("lora_modules") and the 8-bit storage ("quantize")."""
    quantize = unet_kind(quantize_unet)
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    read, fill = loads.read, loads.fill

    unet_cfg = unet_cfg or sd15_unet_config(dtype=dtype)
    unet_cfg = dataclasses.replace(unet_cfg, dtype=dtype,
                                   in_channels=9 if inpainting else
                                   unet_cfg.in_channels)
    vae_cfg = dataclasses.replace(vae_cfg or VAEConfig(), dtype=dtype)
    clip_cfg = dataclasses.replace(clip_cfg or CLIPTextConfig(), dtype=dtype)

    parts = CK.split_sd15(read(ckpt))
    vae_path, vae_sd = loads.vae(ckpt, parts.pop(CK.PREFIX_VAE), vae_ckpt)
    unet = loads.unet(unet_cfg, parts.pop(CK.PREFIX_UNET), ckpt, "UNet",
                      quantize, loras)
    clip = fill(_on_meta(CLIPTextModel, clip_cfg, dtype),
                parts.pop(CK.PREFIX_CLIP_SD15), ckpt, "CLIP")
    vae = fill(_on_meta(AutoencoderKL, vae_cfg, dtype), vae_sd, vae_path, "VAE")
    del parts, vae_sd

    loads.merge_loras(loras, unet, clip, unet_cfg)
    loads.quantize_after_merge(unet, "UNet", quantize, loras)

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
                     refiner_ckpt: Optional[str] = None,
                     loras: Sequence[Tuple[str, float]] = (),
                     embedding_dir: Optional[str] = None,
                     inpainting: bool = False,
                     device=None, dtype: torch.dtype = torch.bfloat16,
                     quantize_unet: Optional[str] = None) -> SDXLBundle:
    """An SDXL bundle on `device` (CUDA unless named) in `dtype` from a
    single-file checkpoint (the sgm key layout; with `inpainting`, the
    9-channel inpainting UNet's), an optional standalone VAE, an optional
    refiner file (sd_xl_refiner_1.0's layout: its UNet and bigG), (path,
    weight) LoRAs merged into the base model (UNet, te1 -> CLIP-L, te2 ->
    OpenCLIP bigG) and a TI directory (two-tower files give each tower its
    entry), at the published configs; `quantize_unet` (the
    base's and the refiner's UNet) and `load_report` as in
    load_sd15_bundle."""
    quantize = unet_kind(quantize_unet)
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    unet_cfg = dataclasses.replace(sdxl_base_unet_config(), dtype=dtype,
                                   in_channels=9 if inpainting else 4)
    vae_cfg = dataclasses.replace(sdxl_vae_config(), dtype=dtype)
    clip_cfg = dataclasses.replace(CLIPTextConfig(), dtype=dtype)
    openclip_cfg = dataclasses.replace(openclip_bigg_config(), dtype=dtype)

    parts = CK.split_sdxl(loads.read(ckpt))
    vae_path, vae_sd = loads.vae(ckpt, parts.pop(CK.PREFIX_VAE), vae_ckpt)
    unet = loads.unet(unet_cfg, parts.pop(CK.PREFIX_UNET), ckpt, "UNet",
                      quantize, loras)
    clip = loads.fill(_on_meta(CLIPTextModel, clip_cfg, dtype),
                      parts.pop(CK.PREFIX_CLIP_SDXL), ckpt, "CLIP-L")
    oc = loads.fill(_on_meta(OpenCLIPTextModel, openclip_cfg, dtype),
                    parts.pop(CK.PREFIX_OPENCLIP_SDXL), ckpt, "OpenCLIP")
    vae = loads.fill(_on_meta(AutoencoderKL, vae_cfg, dtype), vae_sd,
                     vae_path, "VAE")
    del parts, vae_sd
    loads.merge_loras(loras, unet, clip, unet_cfg, text2=oc)
    loads.quantize_after_merge(unet, "UNet", quantize, loras)
    tok = default_tokenizer()
    cond = SDXLConditioner(clip, oc, tok, embedding_dir)
    refiner_unet = refiner_cond = None
    if refiner_ckpt:
        r_cfg = dataclasses.replace(sdxl_refiner_unet_config(), dtype=dtype)
        rparts = CK.split_sdxl_refiner(loads.read(refiner_ckpt))
        refiner_unet = loads.unet(r_cfg, rparts.pop(CK.PREFIX_UNET),
                                  refiner_ckpt, "refiner UNet", quantize, ())
        roc = loads.fill(_on_meta(OpenCLIPTextModel, openclip_cfg, dtype),
                         rparts.pop(CK.PREFIX_OPENCLIP_REFINER), refiner_ckpt,
                         "refiner OpenCLIP")
        del rparts
        refiner_cond = SDXLConditioner(None, roc, tok, embedding_dir,
                                       refiner_mode=True)
    return SDXLBundle(unet=unet, conditioner=cond, vae=vae,
                      refiner_unet=refiner_unet,
                      refiner_conditioner=refiner_cond,
                      load_report=loads.report)


def load_flux_bundle(ckpt: str, vae_ckpt: str, clip_ckpt: Optional[str] = None,
                     t5_ckpt: Optional[str] = None, t5_tokenize=None,
                     guidance_embed: bool = False,
                     quantize: Optional[str] = "float8_e4m3",
                     device=None, dtype: torch.dtype = torch.bfloat16):
    """A FLUX.1 bundle on `device` (CUDA unless named) from its four files,
    as the JAX loader assembles them: the BFL transformer (bare keys or
    under `model.diffusion_model.`), BFL's `ae.safetensors`, HF's CLIP-L
    (`text_model.`) and HF's T5 encoder. `quantize` (default
    "float8_e4m3"; "float8_e5m2", "int8", or None / "none" for bf16)
    stores the transformer's and T5's linear weights in 8 bits, each
    quantized from its file tensor on the device as it loads, as JAX
    quantizes them; CLIP and the VAE stay in `dtype`. Without `t5_ckpt`
    (or `t5_tokenize`) the T5 context is zeros, as in JAX. JAX runs a
    randomly initialised CLIP-L when no `clip_ckpt` is named; the port
    refuses. `load_report` as in load_sd15_bundle."""
    if not clip_ckpt:
        raise FileNotFoundError(
            "FLUX needs clip_ckpt (CLIP-L in HF's text_model. layout): the "
            "JAX loader runs a randomly initialised CLIP-L without it, the "
            "port refuses")
    quantize = _dit_kind(quantize)
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    cfg = (flux_dev_config if guidance_embed else flux_schnell_config)(
        dtype=dtype)
    model = loads.fill(
        _on_meta(FluxModel, cfg, dtype, quantize),
        CK.strip_optional_prefix(loads.read(ckpt), CK.PREFIX_UNET), ckpt,
        "FLUX transformer", quantize)
    vae = loads.fill(
        _on_meta(AutoencoderKL, flux_vae_config(dtype=dtype), dtype),
        CK.strip_optional_prefix(loads.read(vae_ckpt), CK.PREFIX_VAE),
        vae_ckpt, "VAE")
    clip = loads.fill(
        _on_meta(CLIPTextModel, CLIPTextConfig(dtype=dtype), dtype),
        CK.component_state_dict(loads.read(clip_ckpt), "text_model."),
        clip_ckpt, "CLIP-L")
    t5 = None
    if t5_ckpt:
        t5 = loads.fill(
            _on_meta(T5Encoder, t5_xxl_config(dtype=dtype), dtype, quantize),
            CK.t5_encoder_state_dict(loads.read(t5_ckpt)), t5_ckpt, "T5",
            quantize)
    cond = FluxConditioner(clip, default_tokenizer(), t5=t5,
                           t5_tokenize=t5_tokenize)
    return FluxBundle(model=model, conditioner=cond, vae=vae,
                      load_report=loads.report)


def load_svd_bundle(ckpt: str, num_frames: int = 14,
                    quantize_unet: Optional[str] = None, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> SVDBundle:
    """An SVD bundle on `device` (CUDA unless named) in `dtype` from its
    one file (io/checkpoint.py `split_svd`): the video UNet for
    `num_frames` frames, the image VAE from `first_stage_model.` (the
    file's temporal-decoder layers dropped, as JAX never reads them) and
    the ViT-H image tower, None when the file has no visual keys (the
    pipeline then conditions on zeros, as in JAX). `quantize_unet` and
    `load_report` as in load_sd15_bundle: float8_e4m3 / float8_e5m2
    storage of the video UNet's linear weights, int8 refused."""
    quantize = unet_kind(quantize_unet)
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    parts = CK.split_svd(loads.read(ckpt))
    unet = loads.fill(
        _on_meta(functools.partial(VideoUNet, num_frames=num_frames),
                 dataclasses.replace(svd_unet_config(), dtype=dtype), dtype,
                 quantize),
        parts.pop(CK.PREFIX_UNET), ckpt, "video UNet", quantize)
    vae = loads.fill(_on_meta(AutoencoderKL, VAEConfig(dtype=dtype), dtype),
                     parts.pop(CK.PREFIX_VAE), ckpt, "VAE")
    visual = parts.pop(CK.PREFIX_VISUAL_SVD)
    clip_vision = None
    if visual:
        clip_vision = loads.fill(
            _on_meta(CLIPVisionModel, vit_h14_config(dtype=dtype), dtype),
            visual, ckpt, "CLIP-H image tower")
    return SVDBundle(unet=unet, vae=vae, clip_vision=clip_vision,
                     load_report=loads.report)


def load_sd3_bundle(ckpt: str, include_t5: bool = True, t5_tokenize=None,
                    embedding_dir: Optional[str] = None,
                    quantize_t5: Optional[str] = None,
                    quantize_dit: Optional[str] = None,
                    quantize_min_size: int = MIN_SIZE, device=None,
                    dtype: torch.dtype = torch.bfloat16) -> SD3Bundle:
    """An SD3-medium bundle on `device` (CUDA unless named) in `dtype` from
    its one file in the published layout (io/checkpoint.py `split_sd3`):
    the MMDiT, the 16-channel VAE, CLIP-L, bigG and, when `include_t5` is
    set and the file has T5 keys, T5-XXL (loaded as in JAX even though
    the served request conditions on zeros: the factory passes no
    `t5_tokenize`). `quantize_dit` ("float8_e4m3", "float8_e5m2", "int8";
    None or "none" for none) stores the MMDiT's linear weights of at least
    `quantize_min_size` elements in 8 bits, and under int8 its patch
    embedding too, as JAX's `_quantize_tree`; `quantize_t5` T5's linear
    weights (at the default min size, as JAX). Each is quantized from its
    file tensor on the device as it loads. `load_report` as in
    load_sd15_bundle."""
    quantize, q_t5 = _dit_kind(quantize_dit), _dit_kind(quantize_t5)
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    parts = CK.split_sd3(loads.read(ckpt))
    mmdit = loads.fill(
        _on_meta(MMDiT, sd3_medium_config(dtype=dtype), dtype, quantize,
                 min_size=quantize_min_size, include_convs=quantize == "int8"),
        parts.pop(CK.PREFIX_UNET), ckpt, "MMDiT", quantize)
    vae = loads.fill(_on_meta(AutoencoderKL, sd3_vae_config(dtype=dtype), dtype),
                     parts.pop(CK.PREFIX_VAE), ckpt, "VAE")
    clip = loads.fill(_on_meta(CLIPTextModel, CLIPTextConfig(dtype=dtype), dtype),
                      parts.pop(CK.PREFIX_SD3_CLIP_L), ckpt, "CLIP-L")
    oc = loads.fill(
        _on_meta(OpenCLIPTextModel, openclip_bigg_config(dtype=dtype), dtype),
        parts.pop(CK.PREFIX_SD3_CLIP_G), ckpt, "OpenCLIP bigG")
    t5_sd = parts.pop(CK.PREFIX_SD3_T5)
    t5 = None
    if include_t5 and t5_sd:
        t5 = loads.fill(_on_meta(T5Encoder, t5_xxl_config(dtype=dtype), dtype,
                                 q_t5), t5_sd, ckpt, "T5", q_t5)
    del parts, t5_sd
    cond = SD3Conditioner(clip, oc, default_tokenizer(), t5=t5,
                          t5_tokenize=t5_tokenize, embedding_dir=embedding_dir)
    return SD3Bundle(mmdit=mmdit, conditioner=cond, vae=vae,
                     load_report=loads.report)


def load_pixart_bundle(transformer_ckpt: str, vae_ckpt: Optional[str] = None,
                       t5_tokenize=None, t5_len: int = 120,
                       quantize_dit: Optional[str] = None,
                       quantize_min_size: int = MIN_SIZE, device=None,
                       dtype: torch.dtype = torch.bfloat16) -> PixArtBundle:
    """A PixArt-Σ bundle on `device` (CUDA unless named) in `dtype` from a
    diffusers PixArtTransformer2DModel file (io/diffusers_keys.py
    `pixart_from_diffusers`) and a standalone VAE file (the SD VAE
    architecture at JAX's `VAEConfig()` scale, 0.18215). No T5 tower is
    loaded, as in JAX: the caption is zeros of (t5_len, 4096).
    `quantize_dit` as in load_sd3_bundle. JAX decodes with an all-zero VAE
    when no `vae_ckpt` is named; the port refuses. `load_report` as in
    load_sd15_bundle."""
    if not vae_ckpt:
        raise FileNotFoundError(
            "PixArt needs vae_ckpt (the SD VAE as a standalone file): the JAX "
            "loader decodes with an all-zero VAE without it, the port refuses")
    quantize = _dit_kind(quantize_dit)
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    dit = loads.fill(
        _on_meta(PixArt, pixart_sigma_xl_config(dtype=dtype), dtype, quantize,
                 min_size=quantize_min_size, include_convs=quantize == "int8"),
        pixart_from_diffusers(loads.read(transformer_ckpt)), transformer_ckpt,
        "PixArt DiT", quantize)
    vae = loads.fill(
        _on_meta(AutoencoderKL, VAEConfig(dtype=dtype), dtype),
        CK.component_state_dict(CK.vae_state_dict_from_standalone(
            loads.read(vae_ckpt)), CK.PREFIX_VAE), vae_ckpt, "VAE")
    return PixArtBundle(dit=dit, vae=vae, t5_tokenize=t5_tokenize,
                        t5_len=t5_len, load_report=loads.report)


def standalone_vae_state_dict(sd) -> Dict[str, torch.Tensor]:
    """A standalone VAE file's keys as models/vae.py names them: the CompVis
    layout (bare or under `first_stage_model.`), or diffusers'
    AutoencoderKL layout through io/diffusers_keys.py
    `sd_vae_from_diffusers`."""
    if is_diffusers_vae(sd):
        return sd_vae_from_diffusers(sd)
    return CK.component_state_dict(CK.vae_state_dict_from_standalone(sd),
                                   CK.PREFIX_VAE)


def bert_state_dict(sd) -> Dict[str, torch.Tensor]:
    """An HF BertModel file's keys as models/bert.py names them: under
    `bert.` where the file has that prefix (the keys outside it dropped, as
    JAX reads it), the position_ids buffer dropped."""
    if any(k.startswith("bert.") for k in sd):
        sd = {k[len("bert."):]: v for k, v in sd.items()
              if k.startswith("bert.")}
    return {k: v for k, v in sd.items() if k != CK.POSITION_IDS}


def load_hunyuan_bundle(dit_ckpt: str, vae_ckpt: Optional[str] = None,
                        clip_ckpt: Optional[str] = None,
                        clip_vocab: Optional[str] = None,
                        mt5_ckpt: Optional[str] = None, mt5_tokenize=None,
                        quantize_dit: Optional[str] = None,
                        quantize_min_size: int = MIN_SIZE, device=None,
                        dtype: torch.dtype = torch.bfloat16) -> HunyuanBundle:
    """A Hunyuan-DiT bundle on `device` (CUDA unless named) in `dtype` from
    its component files, as JAX's loader takes them: the diffusers
    HunyuanDiT2DModel transformer (io/diffusers_keys.py
    `hunyuan_from_diffusers`), the SDXL VAE as a standalone file in the
    CompVis or diffusers layout (`standalone_vae_state_dict`; JAX reads the
    CompVis one only), the Chinese-CLIP BertModel in HF's layout
    (`clip_ckpt`) with its `clip_vocab` vocab.txt, and the mT5-XL encoder
    in HF's T5EncoderModel layout (`mt5_ckpt`) with `mt5_tokenize` (a
    spiece.model path or bytes, or a callable). A missing text branch
    gives zero contexts, as in JAX (pipelines/hunyuan.py
    `HunyuanTextEncoder`). `quantize_dit` as in load_sd3_bundle (the
    patch embedding, 22,528 elements at full width, stays below the min
    size). JAX decodes with an all-zero VAE when no `vae_ckpt` is named;
    the port refuses. Every part loads strictly. `load_report` as in
    load_sd15_bundle."""
    if not vae_ckpt:
        raise FileNotFoundError(
            "Hunyuan-DiT needs vae_ckpt (the SDXL VAE as a standalone file): "
            "the JAX loader decodes with an all-zero VAE without it, the port "
            "refuses")
    quantize = _dit_kind(quantize_dit)
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    cfg = hunyuan_dit_config(dtype=dtype)
    dit = loads.fill(
        _on_meta(HunyuanDiT, cfg, dtype, quantize, min_size=quantize_min_size,
                 include_convs=quantize == "int8"),
        hunyuan_from_diffusers(loads.read(dit_ckpt)), dit_ckpt, "Hunyuan DiT",
        quantize)
    vae = loads.fill(
        _on_meta(AutoencoderKL, sdxl_vae_config(dtype=dtype), dtype),
        standalone_vae_state_dict(loads.read(vae_ckpt)), vae_ckpt, "VAE")
    bert = mt5 = None
    if clip_ckpt:
        bert = loads.fill(
            _on_meta(BertModel, hunyuan_clip_config(dtype=dtype), dtype),
            bert_state_dict(loads.read(clip_ckpt)), clip_ckpt, "BERT")
    if mt5_ckpt:
        mt5 = loads.fill(
            _on_meta(T5Encoder, mt5_xl_config(dtype=dtype), dtype),
            CK.t5_encoder_state_dict(loads.read(mt5_ckpt)), mt5_ckpt, "mT5")
    text = HunyuanTextEncoder(bert, clip_vocab, mt5, mt5_tokenize,
                              cfg.text_len, cfg.text_len_t5, cfg.clip_dim,
                              cfg.mt5_dim)
    return HunyuanBundle(dit=dit, vae=vae, text=text, load_report=loads.report)


def hf_text_tower_state_dict(sd) -> Dict[str, torch.Tensor]:
    """An HF CLIPTextModelWithProjection file (`text_model.*` and
    `text_projection.weight`) -> the port's OpenCLIPTextModel keys
    (io/checkpoint.py `hf_text_to_openclip`); the position_ids buffer
    dropped, any other key raises."""
    tower = {}
    for k, v in sd.items():
        if k == "text_projection.weight":
            tower[k] = v
        elif k.startswith("text_model.") and k != "text_model." + CK.POSITION_IDS:
            tower[k[len("text_model."):]] = v
        elif k != "text_model." + CK.POSITION_IDS:
            raise KeyError(f"HF CLIP text tower file: unknown key {k}")
    return CK.hf_text_to_openclip(tower)


def hf_text_tower_config(sd, dtype: torch.dtype) -> OpenCLIPTextConfig:
    """The tower's dimensions from its tensors (`hf_text_tower_state_dict`
    keys), with JAX's 64-wide heads."""
    vocab, width = sd["token_embedding.weight"].shape
    layers = 1 + max(int(k.split(".")[2]) for k in sd
                     if k.startswith("transformer.resblocks."))
    return OpenCLIPTextConfig(
        vocab_size=vocab, width=width, num_layers=layers,
        num_heads=max(1, width // 64),
        max_positions=sd["positional_embedding"].shape[0],
        mlp_ratio=sd["transformer.resblocks.0.mlp.c_fc.weight"].shape[0] // width,
        dtype=dtype)


def load_kandinsky_bundle(prior_ckpt: str, decoder_ckpt: str,
                          text_encoder_ckpt: str,
                          movq_ckpt: Optional[str] = None, device=None,
                          dtype: torch.dtype = torch.bfloat16) -> KandinskyBundle:
    """A Kandinsky 2.2 bundle on `device` (CUDA unless named) in `dtype` from
    its four diffusers component files, as JAX's loader takes them: the
    prior (a PriorTransformer, io/diffusers_keys.py
    `kandinsky_prior_from_diffusers`, with its clip_mean and clip_std),
    the decoder UNet with its image heads (`kandinsky_decoder_from_diffusers`;
    the conditioner's dimensions and the UNet's context width from the
    head tensors), the bigG text tower in HF's CLIPTextModelWithProjection
    layout (its dimensions from the tensors) and MoVQ (a VQModel,
    `movq_decoder_from_diffusers`), the prior, the UNet and MoVQ at the
    published widths (JAX's default configs).
    Without `movq_ckpt` JAX's bundle has no decoder for the latent; the
    port refuses. Every part loads strictly. `load_report` as in
    load_sd15_bundle."""
    if not movq_ckpt:
        raise FileNotFoundError(
            "Kandinsky 2.2 needs movq_ckpt (the MoVQ VQModel file): without "
            "it the JAX bundle has no decoder for the latent, the port refuses")
    device = resolve_device(device)
    loads = _Loads(device, dtype)
    psd = kandinsky_prior_from_diffusers(loads.read(prior_ckpt))
    clip_mean, clip_std = (psd.pop(k, None) for k in ("clip_mean", "clip_std"))
    prior = loads.fill(_on_meta(DiffusionPrior, PriorConfig(dtype=dtype), dtype),
                       psd, prior_ckpt, "Kandinsky prior")
    body, heads = kandinsky_decoder_from_diffusers(loads.read(decoder_ckpt))
    ted, embed_dim = heads["image_proj.weight"].shape
    cross = heads["context_norm.weight"].shape[0]
    dcfg = KandinskyUNetConfig(in_channels=4, context_dim=cross, dtype=dtype)
    decoder = loads.fill(_on_meta(KandinskyUNet, dcfg, dtype), body,
                         decoder_ckpt, "Kandinsky decoder UNet")
    with torch.device("meta"):
        cond = set_compute_dtype(KandinskyImageConditioner(
            embed_dim, ted, cross, heads["context_proj.weight"].shape[0] // cross,
            dtype), dtype)
    cond = loads.fill(cond, heads, decoder_ckpt, "Kandinsky image conditioner")
    tsd = hf_text_tower_state_dict(loads.read(text_encoder_ckpt))
    tower = loads.fill(_on_meta(OpenCLIPTextModel,
                                hf_text_tower_config(tsd, dtype), dtype),
                       tsd, text_encoder_ckpt, "bigG text tower")
    movq = loads.fill(_on_meta(MoVQ, MoVQConfig(dtype=dtype), dtype),
                      movq_decoder_from_diffusers(loads.read(movq_ckpt)),
                      movq_ckpt, "MoVQ")
    return KandinskyBundle(
        prior=prior, decoder=decoder, image_cond=cond, movq=movq,
        text=KandinskyTextEncoder(tower),
        clip_mean=None if clip_mean is None else clip_mean.reshape(-1).float(),
        clip_std=None if clip_std is None else clip_std.reshape(-1).float(),
        load_report=loads.report)
