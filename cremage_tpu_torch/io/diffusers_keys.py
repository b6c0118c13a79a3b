"""diffusers checkpoint layouts -> the port's module layouts (the port's copy
of the part of cremage_tpu/io/diffusers_keys.py that its families use).

PixArt-Σ ships as a diffusers `PixArtTransformer2DModel`
(`pixart_from_diffusers`); the port's models/pixart.py is named after
the PixArt repository's keys, as the JAX module is:

    pos_embed.proj                                -> x_embedder.proj
    adaln_single.emb.timestep_embedder.linear_1/2 -> t_embedder.mlp.0/2
    adaln_single.linear                           -> t_block.1
    caption_projection.linear_1/2                 -> y_embedder.y_proj.fc1/fc2
    transformer_blocks.N.scale_shift_table        -> blocks.N.scale_shift_table
    transformer_blocks.N.attn1.to_{q,k,v}         -> blocks.N.attn.qkv (fused)
    transformer_blocks.N.attn1.to_out.0           -> blocks.N.attn.proj
    transformer_blocks.N.attn2.to_q               -> blocks.N.cross_attn.q_linear
    transformer_blocks.N.attn2.to_{k,v}           -> blocks.N.cross_attn.kv_linear (fused)
    transformer_blocks.N.attn2.to_out.0           -> blocks.N.cross_attn.proj
    transformer_blocks.N.ff.net.0.proj            -> blocks.N.mlp.fc1
    transformer_blocks.N.ff.net.2                 -> blocks.N.mlp.fc2
    scale_shift_table                             -> final_layer.scale_shift_table
    proj_out                                      -> final_layer.linear

The fused projections concatenate their parts along the output rows in
[q; k; v] ([k; v]) order. The JAX converter skips keys it does not know;
this one raises on them (the port's loaders are strict).
"""
from __future__ import annotations

import re
from typing import Dict, Mapping

import torch

_TOP = (("pos_embed.proj.", "x_embedder.proj."),
        ("adaln_single.emb.timestep_embedder.linear_1.", "t_embedder.mlp.0."),
        ("adaln_single.emb.timestep_embedder.linear_2.", "t_embedder.mlp.2."),
        ("adaln_single.linear.", "t_block.1."),
        ("caption_projection.linear_1.", "y_embedder.y_proj.fc1."),
        ("caption_projection.linear_2.", "y_embedder.y_proj.fc2."),
        ("proj_out.", "final_layer.linear."))
_BLOCK = (("attn1.to_out.0.", "attn.proj."),
          ("attn2.to_q.", "cross_attn.q_linear."),
          ("attn2.to_out.0.", "cross_attn.proj."),
          ("ff.net.0.proj.", "mlp.fc1."),
          ("ff.net.2.", "mlp.fc2."))
_FUSED = re.compile(r"^attn([12])\.to_([qkv])\.(weight|bias)$")


def pixart_from_diffusers(sd: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A diffusers PixArtTransformer2DModel state dict -> the port's
    PixArt keys (the module docstring's table). Unknown keys raise."""
    out: Dict[str, torch.Tensor] = {}
    fused: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        if k == "scale_shift_table":
            out["final_layer.scale_shift_table"] = v
            continue
        m = re.match(r"^transformer_blocks\.(\d+)\.(.+)$", k)
        if m:
            base, rest = f"blocks.{m.group(1)}.", m.group(2)
            f = _FUSED.match(rest)
            if rest == "scale_shift_table":
                out[base + rest] = v
            elif f and (f.group(1) == "1" or f.group(2) != "q"):
                name = "attn.qkv." if f.group(1) == "1" else "cross_attn.kv_linear."
                fused.setdefault(base + name + f.group(3), {})[f.group(2)] = v
            else:
                for a, b in _BLOCK:
                    if rest.startswith(a):
                        out[base + b + rest[len(a):]] = v
                        break
                else:
                    raise KeyError(f"PixArt diffusers file: unknown key {k}")
            continue
        for a, b in _TOP:
            if k.startswith(a):
                out[b + k[len(a):]] = v
                break
        else:
            raise KeyError(f"PixArt diffusers file: unknown key {k}")
    for key, parts in fused.items():
        order = "qkv" if ".attn.qkv." in key else "kv"
        if set(parts) != set(order):
            raise KeyError(f"PixArt diffusers file: {key} lacks "
                           f"{sorted(set(order) - set(parts))}")
        out[key] = torch.cat([parts[c] for c in order], dim=0)
    return out
