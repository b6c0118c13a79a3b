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
  other key raises. SDXL's OpenCLIP tower stores its attention input
  projection fused (`attn.in_proj_weight` / `in_proj_bias`, rows [q; k; v]);
  `openclip_text_subdict` splits it into the port's q/k/v projections.
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
PREFIX_CONTROLNET = "control_model."
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


def load_into(module: torch.nn.Module, sd: Mapping[str, torch.Tensor],
              device, what: str) -> torch.nn.Module:
    """Load `sd` into `module` (strict: missing or unexpected keys and
    shape mismatches raise), each tensor converted to its parameter's
    dtype on the way to `device`, so the host holds no converted copy.
    `module` may live on the meta device."""
    ref = module.state_dict()
    missing = sorted(set(ref) - set(sd))
    unexpected = sorted(set(sd) - set(ref))
    if missing or unexpected:
        raise KeyError(f"{what}: missing {len(missing)} keys {missing[:5]}, "
                       f"unexpected {len(unexpected)} {unexpected[:5]}")
    new = {}
    for k, r in ref.items():
        t = sd[k]
        if tuple(t.shape) != tuple(r.shape):
            raise ValueError(f"{what}: {k} has shape {tuple(t.shape)} in the "
                             f"file, the model wants {tuple(r.shape)}")
        new[k] = t.to(device=device, dtype=r.dtype)
    module.load_state_dict(new, strict=True, assign=True)
    return module
