"""diffusers checkpoint layouts -> the port's module layouts (the port's copy
of the part of cremage_tpu/io/diffusers_keys.py that its families use).

Each converter raises on a key it does not know, where JAX's skips it (the
port's loaders are strict). The fused projections concatenate their parts
along the output rows in [q; k; v] ([k; v]) order.

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

Hunyuan-DiT ships as a diffusers `HunyuanDiT2DModel`
(`hunyuan_from_diffusers`, names as JAX's converter gives them, which the
port's models/hunyuan.py takes):

    pos_embed.proj                                -> x_embedder.proj
    time_extra_emb.timestep_embedder.linear_1/2   -> t_embedder.mlp_0/mlp_2
    time_extra_emb.pooler.*                       -> pooler.*
    time_extra_emb.extra_embedder.linear_1/2      -> extra_embedder.fc1/fc2
    text_embedder.linear_1/2, text_embedding_padding  (as they are)
    blocks.N.norm1.norm / norm1.linear            -> blocks.N.norm1 / default_modulation_1
    blocks.N.attn1.to_{q,k,v}                     -> blocks.N.attn1_qkv (fused)
    blocks.N.attn{1,2}.norm_{q,k}                 -> blocks.N.attn{1,2}_{q,k}_norm
    blocks.N.attn{1,2}.to_out.0                   -> blocks.N.attn{1,2}_proj
    blocks.N.attn2.to_q                           -> blocks.N.attn2_q
    blocks.N.attn2.to_{k,v}                       -> blocks.N.attn2_kv (fused)
    blocks.N.ff.net.0.proj / ff.net.2             -> blocks.N.mlp_fc1 / mlp_fc2
    blocks.N.{norm2,norm3,skip_norm,skip_linear}  (as they are)
    norm_out.linear                               -> final_adaLN_1
    proj_out                                      -> final_linear

Kandinsky 2.2 ships as diffusers component files:
- the prior, a `PriorTransformer` (`kandinsky_prior_from_diffusers`, names
  as JAX's converter gives them, which the port's models/kandinsky.py
  takes; `clip_mean` and `clip_std` beside them):

    time_embedding.linear_1/2                     (as they are)
    proj_in                                       -> image_embed_proj
    embedding_proj                                -> pooled_proj
    encoder_hidden_states_proj                    -> text_proj
    positional_embedding (1, N, C)                -> positional_embedding (N, C)
    prd_embedding, clip_mean, clip_std            (as they are)
    transformer_blocks.N.norm1 / norm3            -> blocks.N.ln_1 / ln_2
    transformer_blocks.N.attn1.to_{q,k,v}         -> blocks.N.{q,k,v}_proj
    transformer_blocks.N.attn1.to_out.0           -> blocks.N.out_proj
    transformer_blocks.N.ff.net.0.proj / ff.net.2 -> blocks.N.mlp_fc / mlp_proj
    norm_out / proj_to_clip_embeddings            -> final_ln / out_proj

- the decoder, a `UNet2DConditionModel` (`kandinsky_decoder_from_diffusers`):
  its body as it is (models/kandinsky_decoder.py is named after it), its
  image heads add_embedding.image_proj / image_norm and
  encoder_hid_proj.image_embeds / norm -> image_proj / image_norm /
  context_proj / context_norm of models/kandinsky.py
  `KandinskyImageConditioner`;
- MoVQ, a `VQModel` (`movq_decoder_from_diffusers`): decoder.* and
  post_quant_conv.* as they are (models/vq.py `MoVQ`), the codebook
  (quantize.embedding.weight), the encoder and quant_conv dropped by name.

Hunyuan-DiT's VAE ships as a diffusers `AutoencoderKL`
(`sd_vae_from_diffusers`): the CompVis first-stage layout the port's
models/vae.py takes, the decoder's up blocks in reverse order, the mid
attention's linear weights as 1x1 convolutions.
"""
from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence, Tuple

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


def _fuse(fused: Dict[str, Dict[str, torch.Tensor]], what: str,
          out: Dict[str, torch.Tensor]) -> None:
    """Concatenate each fused projection's parts along the output rows in
    [q; k; v] (a self-attention's qkv) or [k; v] order into `out`; a
    missing part raises."""
    for key, parts in fused.items():
        order = "qkv" if re.search(r"\.(attn\.qkv|attn1_qkv)\.", key) else "kv"
        if set(parts) != set(order):
            raise KeyError(f"{what}: {key} lacks "
                           f"{sorted(set(order) - set(parts))}")
        out[key] = torch.cat([parts[c] for c in order], dim=0)


def _rename(key: str, rest: str, table: Sequence[Tuple[str, str]],
            base: str, what: str) -> str:
    for a, b in table:
        if rest.startswith(a):
            return base + b + rest[len(a):]
    raise KeyError(f"{what}: unknown key {key}")


def pixart_from_diffusers(sd: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """A diffusers PixArtTransformer2DModel state dict -> the port's
    PixArt keys (the module docstring's table). Unknown keys raise."""
    what = "PixArt diffusers file"
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
                out[_rename(k, rest, _BLOCK, base, what)] = v
            continue
        out[_rename(k, k, _TOP, "", what)] = v
    _fuse(fused, what, out)
    return out


_HY_TOP = (("pos_embed.proj.", "x_embedder.proj."),
           ("time_extra_emb.timestep_embedder.linear_1.", "t_embedder.mlp_0."),
           ("time_extra_emb.timestep_embedder.linear_2.", "t_embedder.mlp_2."),
           ("time_extra_emb.pooler.positional_embedding",
            "pooler.positional_embedding"),
           ("time_extra_emb.pooler.q_proj.", "pooler.q_proj."),
           ("time_extra_emb.pooler.k_proj.", "pooler.k_proj."),
           ("time_extra_emb.pooler.v_proj.", "pooler.v_proj."),
           ("time_extra_emb.pooler.c_proj.", "pooler.c_proj."),
           ("time_extra_emb.extra_embedder.linear_1.", "extra_embedder.fc1."),
           ("time_extra_emb.extra_embedder.linear_2.", "extra_embedder.fc2."),
           ("text_embedder.linear_1.", "text_embedder.linear_1."),
           ("text_embedder.linear_2.", "text_embedder.linear_2."),
           ("text_embedding_padding", "text_embedding_padding"),
           ("norm_out.linear.", "final_adaLN_1."),
           ("proj_out.", "final_linear."))
_HY_BLOCK = (("norm1.norm.", "norm1."),
             ("norm1.linear.", "default_modulation_1."),
             ("attn1.norm_q.", "attn1_q_norm."),
             ("attn1.norm_k.", "attn1_k_norm."),
             ("attn1.to_out.0.", "attn1_proj."),
             ("attn2.to_q.", "attn2_q."),
             ("attn2.norm_q.", "attn2_q_norm."),
             ("attn2.norm_k.", "attn2_k_norm."),
             ("attn2.to_out.0.", "attn2_proj."),
             ("norm2.", "norm2."),
             ("norm3.", "norm3."),
             ("ff.net.0.proj.", "mlp_fc1."),
             ("ff.net.2.", "mlp_fc2."),
             ("skip_norm.", "skip_norm."),
             ("skip_linear.", "skip_linear."))


def hunyuan_from_diffusers(sd: Mapping[str, torch.Tensor]
                           ) -> Dict[str, torch.Tensor]:
    """A diffusers HunyuanDiT2DModel state dict -> the port's HunyuanDiT
    keys (the module docstring's table). Unknown keys raise."""
    what = "Hunyuan-DiT diffusers file"
    out: Dict[str, torch.Tensor] = {}
    fused: Dict[str, Dict[str, torch.Tensor]] = {}
    for k, v in sd.items():
        m = re.match(r"^blocks\.(\d+)\.(.+)$", k)
        if not m:
            out[_rename(k, k, _HY_TOP, "", what)] = v
            continue
        base, rest = f"blocks.{m.group(1)}.", m.group(2)
        f = _FUSED.match(rest)
        if f and (f.group(1) == "1" or f.group(2) != "q"):
            name = "attn1_qkv." if f.group(1) == "1" else "attn2_kv."
            fused.setdefault(base + name + f.group(3), {})[f.group(2)] = v
        else:
            out[_rename(k, rest, _HY_BLOCK, base, what)] = v
    _fuse(fused, what, out)
    return out


_VAE_RES = (("norm1.", "norm1."), ("conv1.", "conv1."), ("norm2.", "norm2."),
            ("conv2.", "conv2."), ("conv_shortcut.", "nin_shortcut."))
# the mid attention's current names and the deprecated ones diffusers still
# reads (query / key / value / proj_attn)
_VAE_ATTN = (("group_norm.", "norm."), ("to_q.", "q."), ("to_k.", "k."),
             ("to_v.", "v."), ("to_out.0.", "proj_out."), ("query.", "q."),
             ("key.", "k."), ("value.", "v."), ("proj_attn.", "proj_out."))
_VAE_TOP = (("encoder.conv_in.", "encoder.conv_in."),
            ("encoder.conv_norm_out.", "encoder.norm_out."),
            ("encoder.conv_out.", "encoder.conv_out."),
            ("decoder.conv_in.", "decoder.conv_in."),
            ("decoder.conv_norm_out.", "decoder.norm_out."),
            ("decoder.conv_out.", "decoder.conv_out."),
            ("quant_conv.", "quant_conv."),
            ("post_quant_conv.", "post_quant_conv."))


def is_diffusers_vae(sd: Mapping[str, torch.Tensor]) -> bool:
    """Whether a VAE state dict is in diffusers' AutoencoderKL layout."""
    return any(".down_blocks." in k or ".up_blocks." in k or ".mid_block." in k
               for k in sd)


def sd_vae_from_diffusers(sd: Mapping[str, torch.Tensor],
                          num_levels: int = 4) -> Dict[str, torch.Tensor]:
    """A diffusers AutoencoderKL state dict -> the CompVis first-stage keys
    of models/vae.py (no prefix): down_blocks.L.resnets.B -> down.L.block.B,
    mid_block.resnets.{0,1} -> mid.block_{1,2}, mid_block.attentions.0 ->
    mid.attn_1 (linear weights made 1x1 convolutions), up_blocks.P ->
    up.{num_levels - 1 - P}. Unknown keys raise (JAX's converter drops
    them)."""
    what = "diffusers VAE file"
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        m = re.match(r"^(encoder|decoder)\.mid_block\.(resnets|attentions)"
                     r"\.(\d+)\.(.+)$", k)
        if m:
            side, kind, i, rest = m.groups()
            if kind == "attentions":
                name = _rename(k, rest, _VAE_ATTN, f"{side}.mid.attn_1.", what)
                if v.ndim == 2 and name.endswith("weight"):
                    v = v[:, :, None, None]
            else:
                name = _rename(k, rest, _VAE_RES,
                               f"{side}.mid.block_{int(i) + 1}.", what)
            out[name] = v
            continue
        m = re.match(r"^encoder\.down_blocks\.(\d+)\.(resnets\.(\d+)\.)?(.+)$",
                     k)
        if m:
            lv, block, b, rest = m.groups()
            if block:
                out[_rename(k, rest, _VAE_RES,
                            f"encoder.down.{lv}.block.{b}.", what)] = v
            elif rest.startswith("downsamplers.0.conv."):
                out[f"encoder.down.{lv}.downsample.conv."
                    + rest[len("downsamplers.0.conv."):]] = v
            else:
                raise KeyError(f"{what}: unknown key {k}")
            continue
        m = re.match(r"^decoder\.up_blocks\.(\d+)\.(resnets\.(\d+)\.)?(.+)$", k)
        if m:
            pos, block, b, rest = m.groups()
            level = num_levels - 1 - int(pos)
            if block:
                out[_rename(k, rest, _VAE_RES,
                            f"decoder.up.{level}.block.{b}.", what)] = v
            elif rest.startswith("upsamplers.0.conv."):
                out[f"decoder.up.{level}.upsample.conv."
                    + rest[len("upsamplers.0.conv."):]] = v
            else:
                raise KeyError(f"{what}: unknown key {k}")
            continue
        out[_rename(k, k, _VAE_TOP, "", what)] = v
    return out


_KP_TOP = (("time_embedding.linear_1.", "time_embedding.linear_1."),
           ("time_embedding.linear_2.", "time_embedding.linear_2."),
           ("proj_in.", "image_embed_proj."),
           ("embedding_proj.", "pooled_proj."),
           ("encoder_hidden_states_proj.", "text_proj."),
           ("norm_out.", "final_ln."),
           ("proj_to_clip_embeddings.", "out_proj."),
           ("prd_embedding", "prd_embedding"),
           ("clip_mean", "clip_mean"),
           ("clip_std", "clip_std"))
_KP_BLOCK = (("norm1.", "ln_1."), ("attn1.to_q.", "q_proj."),
             ("attn1.to_k.", "k_proj."), ("attn1.to_v.", "v_proj."),
             ("attn1.to_out.0.", "out_proj."), ("norm3.", "ln_2."),
             ("ff.net.0.proj.", "mlp_fc."), ("ff.net.2.", "mlp_proj."))


def kandinsky_prior_from_diffusers(sd: Mapping[str, torch.Tensor]
                                   ) -> Dict[str, torch.Tensor]:
    """A diffusers PriorTransformer state dict -> the port's DiffusionPrior
    keys and `clip_mean` / `clip_std` (the module docstring's table).
    Unknown keys raise."""
    what = "Kandinsky prior diffusers file"
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k == "positional_embedding":
            out[k] = v[0] if v.ndim == 3 else v
            continue
        m = re.match(r"^transformer_blocks\.(\d+)\.(.+)$", k)
        if m:
            out[_rename(k, m.group(2), _KP_BLOCK, f"blocks.{m.group(1)}.",
                        what)] = v
            continue
        out[_rename(k, k, _KP_TOP, "", what)] = v
    return out


KANDINSKY_HEADS = (("add_embedding.image_proj.", "image_proj."),
                   ("add_embedding.image_norm.", "image_norm."),
                   ("encoder_hid_proj.image_embeds.", "context_proj."),
                   ("encoder_hid_proj.norm.", "context_norm."))


def kandinsky_image_conditioner_from_diffusers(
        sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The image heads of a diffusers Kandinsky 2.2 decoder UNet -> the
    port's KandinskyImageConditioner keys; the other keys are left out."""
    return {dst + k[len(src):]: v for k, v in sd.items()
            for src, dst in KANDINSKY_HEADS if k.startswith(src)}


def kandinsky_decoder_from_diffusers(sd: Mapping[str, torch.Tensor]
                                     ) -> Tuple[Dict[str, torch.Tensor],
                                                Dict[str, torch.Tensor]]:
    """A diffusers Kandinsky 2.2 decoder UNet state dict -> (the body's
    keys as they are, for models/kandinsky_decoder.py; the image heads'
    keys, `kandinsky_image_conditioner_from_diffusers`). A body key the
    UNet does not have raises when it loads (io/checkpoint.py
    `load_into`)."""
    heads = tuple(src for src, _ in KANDINSKY_HEADS)
    body = {k: v for k, v in sd.items() if not k.startswith(heads)}
    return body, kandinsky_image_conditioner_from_diffusers(sd)


# the parts of a diffusers VQModel file the decode does not use
MOVQ_DROPPED_PREFIXES = ("encoder.", "quant_conv.")
MOVQ_CODEBOOK = "quantize.embedding.weight"


def movq_decoder_from_diffusers(sd: Mapping[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """A diffusers VQModel (Kandinsky's MoVQ) state dict -> the port's MoVQ
    keys: decoder.* and post_quant_conv.* as they are; the codebook, the
    encoder and quant_conv dropped by name. Any other key raises."""
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if k.startswith(("decoder.", "post_quant_conv.")):
            out[k] = v
        elif k != MOVQ_CODEBOOK and not k.startswith(MOVQ_DROPPED_PREFIXES):
            raise KeyError(f"Kandinsky MoVQ diffusers file: unknown key {k}")
    return out
