"""LoRA: the kohya key grammar and the load-time weight merge (the port of
cremage_tpu/io/lora.py).

A LoRA is merged into the base weights when the bundle loads,
    W' = W + weight * (alpha / rank) * up @ down,
in float32 and cast back to the weight's dtype, the same arithmetic as the
JAX package (LoRA is linear, so the merged model costs nothing per step).
Several LoRAs merge additively, in order.

Kohya module names map onto the port's module names, which are the torch
checkpoint keys (examples from the reference's canonical list):
  lora_unet_down_blocks_0_attentions_0_transformer_blocks_0_attn1_to_q
      -> UNet input_blocks.1.1.transformer_blocks.0.attn1.to_q
  lora_unet_mid_block_attentions_0_proj_in -> UNet middle_block.1.proj_in
  lora_unet_up_blocks_1_attentions_2_transformer_blocks_0_ff_net_2
      -> UNet output_blocks.5.1.transformer_blocks.0.ff.net.2
  lora_te_text_model_encoder_layers_8_self_attn_v_proj
      -> CLIP encoder.layers.8.self_attn.v_proj
  lora_te2_text_model_encoder_layers_8_mlp_fc1
      -> SDXL's OpenCLIP bigG transformer.resblocks.8.mlp.c_fc
with the suffixes .lora_down.weight / .lora_up.weight / .alpha. kohya
exports bigG (te2) under HF CLIP names; an SDXL LoRA's te1 modules go to
CLIP-L, as in an SD1.5 bundle.
"""
from __future__ import annotations

import logging
import re
from typing import Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from cremage_tpu_torch.models.unet import UNetConfig

logger = logging.getLogger(__name__)


def unet_attention_tables(cfg: UNetConfig):
    """Map diffusers/kohya (down|mid|up)_blocks_{b}_attentions_{a} onto the
    UNet's input/middle/output block names, by walking its block layout."""
    down: Dict[Tuple[int, int], str] = {}
    up: Dict[Tuple[int, int], str] = {}
    idx, ds = 1, 1
    for level in range(len(cfg.channel_mult)):
        for b in range(cfg.num_res_blocks):
            if ds in cfg.attention_resolutions:
                down[(level, b)] = f"input_blocks.{idx}.1"
            idx += 1
        if level != len(cfg.channel_mult) - 1:
            idx += 1
            ds *= 2
    mid = "middle_block.1"
    idx = 0
    for pos, level in enumerate(reversed(range(len(cfg.channel_mult)))):
        for i in range(cfg.num_res_blocks + 1):
            if ds in cfg.attention_resolutions:
                up[(pos, i)] = f"output_blocks.{idx}.1"
            idx += 1
        if level > 0:
            ds //= 2
    return down, mid, up


_TE_RE = re.compile(
    r"^lora_te(\d*)_text_model_encoder_layers_(\d+)_"
    r"(self_attn_(?:q|k|v|out)_proj|mlp_fc1|mlp_fc2)$")
_UNET_ATT_RE = re.compile(
    r"^lora_unet_(down|mid|up)_blocks?_(?:(\d+)_)?attentions_(\d+)_(.+)$")
# non-standard LoRAs that name modules by the SD-native block layout:
#   lora_unet_input_blocks_4_1_transformer_blocks_0_attn1_to_k
#   lora_unet_middle_block_1_proj_in
_UNET_NATIVE_RE = re.compile(
    r"^lora_unet_(input|output|middle)_blocks?_(\d+)(?:_1)?_(.+)$")
_TE_NAMES = {"self_attn_q_proj": "self_attn.q_proj",
             "self_attn_k_proj": "self_attn.k_proj",
             "self_attn_v_proj": "self_attn.v_proj",
             "self_attn_out_proj": "self_attn.out_proj",
             "mlp_fc1": "mlp.fc1", "mlp_fc2": "mlp.fc2"}
# the same HF names on SDXL's OpenCLIP tower (models/open_clip.py)
_TE2_NAMES = {"self_attn_q_proj": "attn.q_proj",
              "self_attn_k_proj": "attn.k_proj",
              "self_attn_v_proj": "attn.v_proj",
              "self_attn_out_proj": "attn.out_proj",
              "mlp_fc1": "mlp.c_fc", "mlp_fc2": "mlp.c_proj"}


def _inner_name(block: str, rest: str) -> Optional[str]:
    if rest in ("proj_in", "proj_out"):
        return f"{block}.{rest}"
    m = re.match(r"^transformer_blocks_(\d+)_(.+)$", rest)
    if not m:
        return None
    d, inner = m.groups()
    tb = f"{block}.transformer_blocks.{d}"
    if inner.startswith(("attn1_", "attn2_")):
        attn, target = inner.split("_", 1)
        names = {"to_q": "to_q", "to_k": "to_k", "to_v": "to_v",
                 "to_out_0": "to_out.0"}
        return f"{tb}.{attn}.{names[target]}" if target in names else None
    if inner == "ff_net_0_proj":
        return f"{tb}.ff.net.0.proj"
    if inner == "ff_net_2":
        return f"{tb}.ff.net.2"
    return None


def kohya_module_to_torch_name(module: str, cfg: UNetConfig
                               ) -> Optional[Tuple[str, str]]:
    """kohya module name -> ("unet" | "te" | "te2", the module's name in
    the port's UNet, CLIP text model or OpenCLIP tower); None for a module
    the grammar does not map. ("te2", SDXL's second text encoder, has no
    model in an SD1.5 bundle: the merge counts it as skipped.)"""
    m = _TE_RE.match(module)
    if m:
        te_idx, layer, rest = m.groups()
        if te_idx == "2":
            return "te2", f"transformer.resblocks.{layer}.{_TE2_NAMES[rest]}"
        return "te", f"encoder.layers.{layer}.{_TE_NAMES[rest]}"
    m = _UNET_ATT_RE.match(module)
    if m:
        where, b, a, rest = m.groups()
        down, mid, up = unet_attention_tables(cfg)
        if where == "down":
            block = down.get((int(b), int(a)))
        elif where == "up":
            block = up.get((int(b), int(a)))
        else:
            block = mid
        name = _inner_name(block, rest) if block else None
        return ("unet", name) if name else None
    m = _UNET_NATIVE_RE.match(module)
    if m:
        where, b, rest = m.groups()
        block = ("middle_block.1" if where == "middle"
                 else f"{where}_blocks.{b}.1")
        name = _inner_name(block, rest)
        return ("unet", name) if name else None
    return None


def group_lora_modules(lora_sd: Mapping[str, torch.Tensor]
                       ) -> Dict[str, Dict[str, torch.Tensor]]:
    """kohya state dict -> {module: {"down", "up", "alpha"}}."""
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in lora_sd.items():
        for suffix, part in ((".lora_down.weight", "down"),
                             (".lora_up.weight", "up"), (".alpha", "alpha")):
            if k.endswith(suffix):
                groups.setdefault(k[:-len(suffix)], {})[part] = v
                break
    return groups


def lora_delta(down: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """up @ down in float32, in the torch layout of the target weight:
    (out, r) @ (r, in) for a linear layer, (out, r, 1, 1) x (r, in, kh, kw)
    for a convolution."""
    down, up = down.float(), up.float()
    if down.ndim == 2:
        return up @ down
    return torch.einsum("orab,rihw->oihw", up, down)


def merge_lora(unet: nn.Module, text: Optional[nn.Module],
               lora_sd: Mapping[str, torch.Tensor], weight: float,
               cfg: UNetConfig, text2: Optional[nn.Module] = None
               ) -> Tuple[int, int, List[str]]:
    """Merge one LoRA into the UNet, the CLIP text model and (SDXL) the
    OpenCLIP tower `text2` in place. -> (merged, skipped, the merged
    modules' names as "unet:..."/"te:..."/"te2:..."). The delta is
    computed on each weight's device."""
    merged, skipped, names = 0, 0, []
    models = {"unet": unet, "te": text, "te2": text2}
    for module, parts in group_lora_modules(lora_sd).items():
        if "down" not in parts or "up" not in parts:
            skipped += 1
            continue
        dest = kohya_module_to_torch_name(module, cfg)
        if dest is None:
            logger.warning("LoRA module not mapped, skipping: %s", module)
            skipped += 1
            continue
        which, name = dest
        model = models.get(which)
        if model is None:
            skipped += 1
            continue
        try:
            layer = model.get_submodule(name)
        except AttributeError:
            logger.warning("LoRA target missing in the model: %s", name)
            skipped += 1
            continue
        w = layer.weight
        rank = parts["down"].shape[0]
        alpha = float(parts["alpha"]) if "alpha" in parts else float(rank)
        down, up = (parts[p].to(w.device) for p in ("down", "up"))
        delta = lora_delta(down, up) * (weight * alpha / rank)
        if delta.ndim == 4 and w.ndim == 2:
            delta = delta.reshape(delta.shape[0], delta.shape[1])
        if tuple(delta.shape) != tuple(w.shape):
            logger.warning("LoRA shape mismatch for %s: %s vs %s", module,
                           tuple(delta.shape), tuple(w.shape))
            skipped += 1
            continue
        with torch.no_grad():
            w.copy_((w.float() + delta).to(w.dtype))
        merged += 1
        names.append(f"{which}:{name}")
    return merged, skipped, names


def parse_lora_option_string(models: str, weights: str):
    """The reference's option format: comma-separated paths and weights
    (missing weights are 1.0; "None" entries are dropped)."""
    paths = [p.strip() for p in models.split(",")
             if p.strip() and p.strip() != "None"] if models else []
    ws = [float(w) for w in weights.split(",") if w.strip()] if weights else []
    ws = ws[:len(paths)] + [1.0] * (len(paths) - len(ws))
    return list(zip(paths, ws))
