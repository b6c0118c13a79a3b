"""Checkpoint files -> tensors, and SD checkpoint keys -> the port's modules
(the port of cremage_tpu/io/checkpoint.py).

- `load_safetensors` reads a .safetensors file without the `safetensors`
  package: the 8-byte little-endian header length, the JSON header, then
  each tensor from its `data_offsets` with `torch.frombuffer` over a
  private (copy-on-write) memory map, so nothing is read before a tensor
  is used and nothing is copied until it is converted. The file comes from
  outside the program: a header over 100 MB, an unknown dtype, offsets that
  overlap or fall outside the data, and a shape whose byte size differs
  from its offsets are refused.
- `load_torch_ckpt` reads a .ckpt / .pt with `torch.load(weights_only=True,
  mmap=True)` and unwraps the `state_dict`-style containers as the JAX
  package does.
- The port's modules are named after the checkpoint keys, so loading a
  component is stripping its prefix (`component_state_dict`). Keys that
  belong to no model (the DDPM schedule buffers, `model_ema.*`, CLIP's
  `position_ids`) are dropped by name (`split_sd15`, `split_sdxl`); any
  other key raises (`split_sdxl_refiner` also drops the refiner file's
  own VAE, which the pipeline never reads: it decodes with the base
  model's). SDXL's OpenCLIP tower stores its attention input
  projection fused (`attn.in_proj_weight` / `in_proj_bias`, rows [q; k; v]);
  `openclip_text_subdict` splits it into the port's q/k/v projections.
- SVD ships as one file (`split_svd`): the video UNet, the image VAE
  under `first_stage_model.` and the OpenCLIP ViT-H image tower under
  `conditioner.embedders.0.open_clip.model.visual.` (its fused attention
  input projection split as SDXL's). Two families of its keys belong to
  no model that the pipeline runs and are dropped by name: the temporal
  layers of sgm's VideoDecoder (`first_stage_model.decoder.` keys with
  `time_stack`, `time_mix` or `mix_factor` in their names: frames are
  decoded with the image decoder, as in JAX), and every conditioner key
  outside the visual tower (open_clip's text-side tables, the other
  embedders' encoder).
- SD3 ships as one file (`split_sd3`): the MMDiT under
  `model.diffusion_model.`, the 16-channel VAE (no quant convs) under
  `first_stage_model.`, CLIP-L and bigG in HF's CLIPTextModelWithProjection
  layout under `text_encoders.clip_{l,g}.transformer.` (bigG mapped onto
  the port's open_clip names by `hf_text_to_openclip`, its projection
  transposed; CLIP-L's projection dropped by name, since SD3 conditions on
  the unprojected pooled output) and, optionally, T5-XXL under
  `text_encoders.t5xxl.transformer.` (HF's encoder layout).
- FLUX ships as separate files: the BFL transformer (bare keys, or under
  `model.diffusion_model.`), HF's T5 encoder (`t5_encoder_state_dict`:
  `encoder.` stripped, the block-0 bias table lifted, the tied
  `embed_tokens` copy of `shared` dropped), BFL's `ae.safetensors` (bare
  `encoder.` / `decoder.` keys, no quant convs) and HF's CLIP-L
  (`text_model.`).
"""
from __future__ import annotations

import json
import logging
import math
import mmap
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

MAX_HEADER_BYTES = 100 * 1024 * 1024

DTYPES = {
    "F16": torch.float16, "BF16": torch.bfloat16, "F32": torch.float32,
    "F64": torch.float64, "I64": torch.int64, "I32": torch.int32,
    "U8": torch.uint8,
}
_NAMES = {v: k for k, v in DTYPES.items()}

# Standard SD checkpoint prefixes of the port's components.
PREFIX_UNET = "model.diffusion_model."
PREFIX_VAE = "first_stage_model."
PREFIX_CLIP_SD15 = "cond_stage_model.transformer.text_model."
PREFIX_CLIP_SDXL = "conditioner.embedders.0.transformer.text_model."
PREFIX_OPENCLIP_SDXL = "conditioner.embedders.1.model."
# the SDXL refiner's one text tower, bigG (sd_xl_refiner_1.0's layout)
PREFIX_OPENCLIP_REFINER = "conditioner.embedders.0.model."
PREFIX_CONTROLNET = "control_model."
# SVD's OpenCLIP ViT-H image tower
PREFIX_VISUAL_SVD = "conditioner.embedders.0.open_clip.model.visual."
# the VideoDecoder's temporal layers (VideoResBlock time_stack and
# mix_factor, AE3DConv time_mix_conv), which the image decoder lacks
SVD_TEMPORAL_DECODER = ("time_stack", "time_mix", "mix_factor")
# SD3's single file: CLIP-L and bigG in HF's CLIPTextModelWithProjection
# layout, HF's T5 encoder (`encoder.` and the shared table under it)
PREFIX_SD3_CLIP_L = "text_encoders.clip_l.transformer.text_model."
PREFIX_SD3_CLIP_G = "text_encoders.clip_g.transformer.text_model."
PREFIX_SD3_T5 = "text_encoders.t5xxl.transformer."
SD3_CLIP_G_PROJECTION = "text_encoders.clip_g.transformer.text_projection.weight"
# CLIP-L's projection: SD3 conditions on the unprojected pooled output
SD3_DROPPED = frozenset(("text_encoders.clip_l.transformer.text_projection.weight",))
# SDXL checkpoint keys of no model of the port besides the SD1.5 ones:
# the sgm denoiser's sigma table (the port builds its own)
SDXL_EXTRA_KEYS = frozenset(("denoiser.sigmas",))
# the OpenCLIP tower's contrastive logit scale and causal-mask buffer
_OPENCLIP_DROPPED = ("logit_scale", "attn_mask")

# keys of an SD1.5 checkpoint that belong to no model of the port: the
# LatentDiffusion schedule buffers (the port builds its schedule), the EMA
# copy of the UNet, and CLIP's position-id buffer
SCHEDULE_KEYS = frozenset((
    "betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_alphas_cumprod",
    "sqrt_one_minus_alphas_cumprod", "log_one_minus_alphas_cumprod",
    "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod",
    "posterior_variance", "posterior_log_variance_clipped",
    "posterior_mean_coef1", "posterior_mean_coef2", "logvar",
    "lvlb_weights"))
POSITION_IDS = "embeddings.position_ids"


def _header(path: str, size: int, f) -> Tuple[dict, int]:
    """-> (header, offset of the data) after checking the length field."""
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
    (n,) = struct.unpack("<Q", raw)
    if n > MAX_HEADER_BYTES:
        raise ValueError(f"{path}: safetensors header of {n} bytes exceeds "
                         f"{MAX_HEADER_BYTES}")
    if 8 + n > size:
        raise ValueError(f"{path}: safetensors header of {n} bytes runs past "
                         f"the end of the file ({size} bytes)")
    try:
        header = json.loads(f.read(n).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{path}: unreadable safetensors header: {e}") from e
    if not isinstance(header, dict):
        raise ValueError(f"{path}: safetensors header is not a JSON object")
    return header, 8 + n


def _entries(path: str, header: dict, data_len: int):
    """Checked (name, dtype, shape, begin, end) of every tensor."""
    out = []
    for name, e in header.items():
        if name == "__metadata__":
            if not isinstance(e, dict):
                raise ValueError(f"{path}: __metadata__ is not an object")
            continue
        if not isinstance(e, dict) or set(e) != {"dtype", "shape",
                                                 "data_offsets"}:
            raise ValueError(f"{path}: bad entry for {name!r}: {e!r}")
        dt, shape, offs = e["dtype"], e["shape"], e["data_offsets"]
        if dt not in DTYPES:
            raise ValueError(f"{path}: {name}: unsupported dtype {dt!r}")
        if not (isinstance(shape, list) and all(
                isinstance(d, int) and not isinstance(d, bool) and d >= 0
                for d in shape)):
            raise ValueError(f"{path}: {name}: bad shape {shape!r}")
        if not (isinstance(offs, list) and len(offs) == 2 and all(
                isinstance(o, int) and not isinstance(o, bool) for o in offs)):
            raise ValueError(f"{path}: {name}: bad data_offsets {offs!r}")
        begin, end = offs
        if not 0 <= begin <= end <= data_len:
            raise ValueError(f"{path}: {name}: data_offsets {offs} outside "
                             f"the {data_len} data bytes")
        itemsize = torch.empty((), dtype=DTYPES[dt]).element_size()
        if math.prod(shape) * itemsize != end - begin:
            raise ValueError(f"{path}: {name}: shape {shape} of {dt} is "
                             f"{math.prod(shape) * itemsize} bytes, its "
                             f"offsets hold {end - begin}")
        out.append((name, DTYPES[dt], tuple(shape), begin, end))
    spans = sorted((b, e, n) for n, _, _, b, e in out if e > b)
    for (_, e0, n0), (b1, _, n1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {n0} and {n1} overlap")
    return out


def load_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """name -> CPU tensor, each a view of a private memory map of the file
    (read lazily, copied only when converted)."""
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header, start = _header(path, size, f)
        entries = _entries(path, header, size - start)
        if size == 0 or not entries:
            return {}
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    out = {}
    for name, dtype, shape, begin, end in entries:
        n = math.prod(shape)
        if n == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        off = start + begin
        itemsize = (end - begin) // n
        if off % itemsize:      # unaligned: copy out of the map
            t = torch.frombuffer(bytearray(buf[off:off + end - begin]),
                                 dtype=dtype)
        else:
            t = torch.frombuffer(buf, dtype=dtype, count=n, offset=off)
        out[name] = t.view(shape)
    return out


def save_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (CPU, contiguous after the call's copy) as a
    .safetensors file readable by the `safetensors` package."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset, parts = 0, []
    for name, t in tensors.items():
        t = t.detach().cpu().contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {t.dtype} not writable")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        parts.append(t)
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in parts:
            if t.numel():
                f.write(t.view(-1).view(torch.uint8).numpy().tobytes())


def _tensor_dict(v) -> bool:
    return (isinstance(v, dict) and bool(v)
            and all(isinstance(x, torch.Tensor) for x in v.values()))


def load_torch_ckpt(path: str) -> Dict[str, torch.Tensor]:
    """A torch-pickle checkpoint's tensors (non-tensor entries dropped).
    Descends into `state_dict`, `model_state_dict`, `params_ema` or
    `params` only when that entry is itself a flat dict of tensors."""
    try:
        obj = torch.load(path, map_location="cpu", weights_only=True,
                         mmap=True)
    except RuntimeError:     # the legacy (non-zip) format cannot be mapped
        obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, torch.Tensor) or not isinstance(obj, dict):
        raise ValueError(f"{path}: not a checkpoint dict ({type(obj).__name__})")
    for key in ("state_dict", "model_state_dict", "params_ema", "params"):
        if _tensor_dict(obj.get(key)):
            obj = obj[key]
            break
    out = {}
    for k, v in obj.items():
        if isinstance(v, torch.Tensor):
            out[k] = v
        else:
            logger.debug("skipping non-tensor key %s", k)
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """.safetensors or a torch checkpoint -> name -> CPU tensor."""
    if path.endswith(".safetensors"):
        return load_safetensors(path)
    return load_torch_ckpt(path)


def component_state_dict(sd: Mapping[str, torch.Tensor],
                         prefix: str) -> Dict[str, torch.Tensor]:
    """The keys under `prefix`, stripped of it (CLIP's position_ids buffer
    dropped: the port's CLIP has none)."""
    out = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    out.pop(POSITION_IDS, None)
    return out


def split_sd15(sd: Mapping[str, torch.Tensor],
               prefixes=(PREFIX_UNET, PREFIX_VAE, PREFIX_CLIP_SD15)
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An SD1.5 single-file state dict -> {prefix: component dict}. Keys
    that belong to no model are dropped by name; any other raises."""
    unknown = [k for k in sd if not k.startswith(prefixes)
               and k not in SCHEDULE_KEYS and not k.startswith("model_ema.")]
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint keys belong to no SD1.5 "
                       f"component (first 10): {sorted(unknown)[:10]}")
    return {p: component_state_dict(sd, p) for p in prefixes}


def split_sdxl(sd: Mapping[str, torch.Tensor]
               ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An SDXL base single-file state dict -> {prefix: component dict}, the
    OpenCLIP tower's in the port's split-q/k/v naming. Keys that belong to
    no model are dropped by name; any other raises."""
    prefixes = (PREFIX_UNET, PREFIX_VAE, PREFIX_CLIP_SDXL,
                PREFIX_OPENCLIP_SDXL)
    unknown = [k for k in sd if not k.startswith(prefixes)
               and k not in SCHEDULE_KEYS and k not in SDXL_EXTRA_KEYS
               and not k.startswith("model_ema.")]
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint keys belong to no SDXL "
                       f"component (first 10): {sorted(unknown)[:10]}")
    out = {p: component_state_dict(sd, p) for p in prefixes[:3]}
    out[PREFIX_OPENCLIP_SDXL] = openclip_text_subdict(sd)
    return out


def split_sdxl_refiner(sd: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An SDXL refiner single-file state dict -> {prefix: component dict}
    of its UNet and its OpenCLIP tower (split q/k/v). Its VAE keys and the
    keys of no model are dropped by name; any other raises."""
    unknown = [k for k in sd if not k.startswith(
        (PREFIX_UNET, PREFIX_OPENCLIP_REFINER, PREFIX_VAE, "model_ema."))
        and k not in SCHEDULE_KEYS and k not in SDXL_EXTRA_KEYS]
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint keys belong to no SDXL "
                       f"refiner component (first 10): {sorted(unknown)[:10]}")
    return {PREFIX_UNET: component_state_dict(sd, PREFIX_UNET),
            PREFIX_OPENCLIP_REFINER: openclip_text_subdict(
                sd, PREFIX_OPENCLIP_REFINER)}


def svd_dropped(key: str) -> bool:
    """Whether an SVD checkpoint key belongs to a family that the pipeline
    never reads (the module docstring)."""
    if key.startswith(PREFIX_VAE + "decoder."):
        return any(tag in key for tag in SVD_TEMPORAL_DECODER)
    return (key.startswith("conditioner.embedders.")
            and not key.startswith(PREFIX_VISUAL_SVD))


def split_svd(sd: Mapping[str, torch.Tensor]
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An SVD single-file state dict -> {prefix: component dict} of the
    video UNet, the VAE and the ViT image tower (split q/k/v; empty when
    the file has none). The dropped families (`svd_dropped`) go; any
    other key that belongs to no component raises."""
    keep = {k: v for k, v in sd.items() if not svd_dropped(k)}
    unknown = [k for k in keep
               if not k.startswith((PREFIX_UNET, PREFIX_VAE, PREFIX_VISUAL_SVD))]
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint keys belong to no SVD "
                       f"component (first 10): {sorted(unknown)[:10]}")
    return {PREFIX_UNET: component_state_dict(keep, PREFIX_UNET),
            PREFIX_VAE: component_state_dict(keep, PREFIX_VAE),
            PREFIX_VISUAL_SVD: openclip_text_subdict(keep, PREFIX_VISUAL_SVD)}


def split_sd3(sd: Mapping[str, torch.Tensor]
              ) -> Dict[str, Dict[str, torch.Tensor]]:
    """An SD3 single-file state dict -> {prefix: component dict} of the
    MMDiT, the VAE, CLIP-L, bigG (in the port's open_clip naming,
    `hf_text_to_openclip`) and T5 (`t5_encoder_state_dict`; empty when the
    file has none). The keys of SD3_DROPPED go; any other key that belongs
    to no component raises."""
    prefixes = (PREFIX_UNET, PREFIX_VAE, PREFIX_SD3_CLIP_L, PREFIX_SD3_CLIP_G,
                PREFIX_SD3_T5)
    unknown = [k for k in sd if not k.startswith(prefixes)
               and k not in SD3_DROPPED and k != SD3_CLIP_G_PROJECTION]
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint keys belong to no SD3 "
                       f"component (first 10): {sorted(unknown)[:10]}")
    g = component_state_dict(sd, PREFIX_SD3_CLIP_G)
    if SD3_CLIP_G_PROJECTION in sd:
        g["text_projection.weight"] = sd[SD3_CLIP_G_PROJECTION]
    return {PREFIX_UNET: component_state_dict(sd, PREFIX_UNET),
            PREFIX_VAE: component_state_dict(sd, PREFIX_VAE),
            PREFIX_SD3_CLIP_L: component_state_dict(sd, PREFIX_SD3_CLIP_L),
            PREFIX_SD3_CLIP_G: hf_text_to_openclip(g),
            PREFIX_SD3_T5: t5_encoder_state_dict(
                component_state_dict(sd, PREFIX_SD3_T5))}


HF_OPENCLIP_LAYER = (("self_attn.", "attn."), ("layer_norm1.", "ln_1."),
                      ("layer_norm2.", "ln_2."), ("mlp.fc1.", "mlp.c_fc."),
                      ("mlp.fc2.", "mlp.c_proj."))


def hf_text_to_openclip(sd: Mapping[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """An HF CLIPTextModel(WithProjection) text tower (keys stripped of
    `text_model.`, its projection as `text_projection.weight`) -> the
    port's OpenCLIPTextModel keys. HF's projection is a Linear weight
    (out, in); open_clip's `text_projection` is used as x @ P, so it is
    the transpose. Any key outside the tower raises."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k == "text_projection.weight":
            out["text_projection"] = v.t()
        elif k == "embeddings.token_embedding.weight":
            out["token_embedding.weight"] = v
        elif k == "embeddings.position_embedding.weight":
            out["positional_embedding"] = v
        elif k.startswith("encoder.layers."):
            i, sub = k[len("encoder.layers."):].split(".", 1)
            for a, b in HF_OPENCLIP_LAYER:
                sub = sub.replace(a, b)
            out[f"transformer.resblocks.{i}.{sub}"] = v
        elif k.startswith("final_layer_norm."):
            out["ln_final." + k[len("final_layer_norm."):]] = v
        else:
            raise KeyError(f"HF CLIP text tower: unknown key {k}")
    return out


def openclip_text_subdict(sd: Mapping[str, torch.Tensor],
                          prefix: str = PREFIX_OPENCLIP_SDXL
                          ) -> Dict[str, torch.Tensor]:
    """The OpenCLIP text tower's keys under `prefix`, stripped, with the
    fused attn.in_proj_{weight,bias} split into q/k/v_proj (row order
    [q; k; v]); logit_scale, attn_mask and any visual.* keys dropped."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        k2 = k[len(prefix):]
        if k2 in _OPENCLIP_DROPPED or k2.startswith("visual."):
            continue
        for kind in ("weight", "bias"):
            if k2.endswith(f"attn.in_proj_{kind}"):
                base = k2[:-len(f"in_proj_{kind}")]
                for name, part in zip(("q", "k", "v"), v.chunk(3, dim=0)):
                    out[f"{base}{name}_proj.{kind}"] = part
                break
        else:
            out[k2] = v
    return out


def vae_state_dict_from_standalone(sd: Mapping[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """A standalone VAE file's keys in the prefixed form of a full
    checkpoint (files that already carry the prefix keep those keys)."""
    if any(k.startswith(PREFIX_VAE) for k in sd):
        return {k: v for k, v in sd.items() if k.startswith(PREFIX_VAE)}
    return {PREFIX_VAE + k: v for k, v in sd.items()
            if k.startswith(("encoder.", "decoder.", "quant_conv",
                             "post_quant_conv"))}


def strip_optional_prefix(sd: Mapping[str, torch.Tensor],
                          prefix: str) -> Dict[str, torch.Tensor]:
    """`sd` with `prefix` stripped where its keys carry it (as the JAX
    loader reads the FLUX transformer and VAE files), else as it is."""
    if any(k.startswith(prefix) for k in sd):
        return component_state_dict(sd, prefix)
    return dict(sd)


T5_BIAS_KEY = "block.0.layer.0.SelfAttention.relative_attention_bias.weight"


def t5_encoder_state_dict(sd: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """An HF T5 encoder file -> the port's T5Encoder keys: `encoder.`
    stripped, block 0's bias table as `relative_attention_bias.weight`
    (the renames of cremage_tpu/pipelines/loader.py), and the tied
    `embed_tokens.weight` copy of `shared.weight` dropped."""
    out = {}
    for k, v in sd.items():
        k = k[len("encoder."):] if k.startswith("encoder.") else k
        if k == "embed_tokens.weight":
            continue
        out["relative_attention_bias.weight" if k == T5_BIAS_KEY else k] = v
    return out


def load_into(module: torch.nn.Module, sd: Mapping[str, torch.Tensor],
              device, what: str, quantize: Optional[str] = None,
              dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """Load `sd` into `module` (strict: missing or unexpected keys and
    shape mismatches raise), each tensor converted to its parameter's
    dtype on the way to `device`, so the host holds no converted copy.
    `module` may live on the meta device. With `quantize` (an 8-bit kind
    of io/quantize.py), each weight that `prepare_8bit` made 8-bit is
    quantized on the device from the file's tensor converted to `dtype`
    (the dtype the model keeps its other weights in, as JAX quantizes its
    parameters in their param dtype), and its weight_scale comes from
    there, not from the file."""
    from cremage_tpu_torch.io.quantize import coded_weights, quantize_weight

    ref = module.state_dict()
    scales = coded_weights(ref)
    if scales and quantize is None:
        raise ValueError(f"{what}: 8-bit weights but no quantize kind")
    derived = set(scales.values())
    missing = sorted(set(ref) - set(sd) - derived)
    unexpected = sorted(set(sd) - set(ref))
    if missing or unexpected:
        raise KeyError(f"{what}: missing {len(missing)} keys {missing[:5]}, "
                       f"unexpected {len(unexpected)} {unexpected[:5]}")
    new = {}
    for k, r in ref.items():
        if k in derived:
            continue
        t = sd[k]
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(t.shape)} in the "
                             f"file, the model wants {tuple(r.shape)}")
        if k in scales:
            new[k], new[scales[k]] = quantize_weight(
                t.to(device=device, dtype=dtype or t.dtype), quantize)
        else:
            new[k] = t.to(device=device, dtype=r.dtype)
    module.load_state_dict(new, strict=True, assign=True)
    return module
