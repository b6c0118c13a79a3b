"""JAX-package parameters -> the port's state dicts.

The JAX modules name their parameters after the torch checkpoint keys
with dots flattened to underscores (cremage_tpu/io/checkpoint.py
`normalize_key`). So each of the port module's own `state_dict()` keys,
normalized the same way, names the flattened JAX path (joined with "_").
Tensors are transposed HWIO -> OIHW for convolutions (DHWIO -> OIDHW for
the video UNet's temporal ones) and (in, out) -> (out, in) for dense
layers; embedding tables and the ViT's `proj` stay as they are. 8-bit
leaves (io/quantize.py: float8 or int8 codes and a `weight_scale`
sibling) carry over bit for bit into a module that `prepare_8bit` gave
8-bit weights. Any missing or unused key raises. Modules named after
the JAX parameters themselves (Kandinsky 2.2's prior, image conditioner,
decoder UNet and MoVQ decoder among them) take `load_from_jax` as it is.

Parameters arrive as a nested dict of numpy arrays (the caller applies
`np.asarray` to each JAX leaf); nothing here imports jax.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Mapping, Tuple

import numpy as np
import torch
from torch import nn

from cremage_tpu_torch.io.quantize import leaf_to_tensor

# rank-2 tensors that are (num, dim) tables, not linear layers
_NO_TRANSPOSE_MARKERS = ("token_embedding", "position_embedding",
                         "positional_embedding", "text_projection",
                         "concept_embeds", "special_care_embeds",
                         "relative_attention_bias", "shared",
                         "scale_shift_table", "word_embeddings",
                         "token_type_embeddings", "text_embedding_padding")
# rank-2 tensors used as x @ P, matched by their whole name
_NO_TRANSPOSE_NAMES = ("proj",)


def normalize_key(key: str) -> str:
    """torch dotted key -> flattened underscore name."""
    return key.replace(".", "_")


def _flatten(tree, path=()) -> Iterable[Tuple[Tuple[str, ...], object]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, path + (str(k),))
    else:
        yield path, tree


def clip_jax_name(key: str) -> str:
    """Normalized port CLIP key -> JAX CLIPTextModel name (embedding
    tables are bare params, the encoder level is dropped)."""
    key = key.replace("embeddings_token_embedding_weight", "token_embedding")
    key = key.replace("embeddings_position_embedding_weight",
                      "position_embedding")
    if key.startswith("encoder_layers_"):
        key = key[len("encoder_"):]
    return key


def state_dict_from_jax(module: nn.Module, params: Mapping,
                        rename: Callable[[str], str] = lambda k: k
                        ) -> Dict[str, torch.Tensor]:
    """The state dict of `module` filled from the JAX parameter tree."""
    flat = {"_".join(path): np.asarray(v) for path, v in _flatten(params)}
    out: Dict[str, torch.Tensor] = {}
    used, missing = set(), []
    for key, ref in module.state_dict().items():
        name = rename(normalize_key(key))
        if name not in flat:
            missing.append(key)
            continue
        arr = flat[name]
        if arr.ndim == 5:
            arr = arr.transpose(4, 3, 0, 1, 2)         # DHWIO -> OIDHW
        elif arr.ndim == 4:
            arr = arr.transpose(3, 2, 0, 1)            # HWIO -> OIHW
        elif arr.ndim == 2 and name not in _NO_TRANSPOSE_NAMES and not any(
                m in name for m in _NO_TRANSPOSE_MARKERS):
            arr = arr.T                                # (in, out) -> (out, in)
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{key}: JAX shape {flat[name].shape} does not "
                             f"convert to {tuple(ref.shape)}")
        out[key] = leaf_to_tensor(np.ascontiguousarray(arr), ref.dtype)
        used.add(name)
    unused = sorted(set(flat) - used)
    if missing or unused:
        raise KeyError(f"JAX -> torch conversion: missing {missing[:10]} "
                       f"({len(missing)}), unused {unused[:10]} ({len(unused)})")
    return out


def load_from_jax(module: nn.Module, params: Mapping,
                  rename: Callable[[str], str] = lambda k: k) -> nn.Module:
    """Load the JAX parameter tree into `module` (strict)."""
    module.load_state_dict(state_dict_from_jax(module, params, rename))
    return module


def load_vae(module: nn.Module, params: Mapping) -> nn.Module:
    """A JAX AutoencoderKL parameter tree (encoder, decoder, quant_conv,
    post_quant_conv) into the port's AutoencoderKL."""
    return load_from_jax(module, params)


def load_clip(module: nn.Module, params: Mapping) -> nn.Module:
    return load_from_jax(module, params, rename=clip_jax_name)


def openclip_jax_name(key: str) -> str:
    """Normalized port OpenCLIP key -> JAX OpenCLIPTextModel name (the
    token table is a bare param there)."""
    return "token_embedding" if key == "token_embedding_weight" else key


def load_open_clip(module: nn.Module, params: Mapping) -> nn.Module:
    """A JAX OpenCLIPTextModel parameter tree into the port's (the
    positional table and text_projection stay as they are)."""
    return load_from_jax(module, params, rename=openclip_jax_name)


def t5_jax_name(key: str) -> str:
    """Normalized port T5Encoder key -> JAX T5Encoder name (its two tables
    are bare params there)."""
    return {"shared_weight": "shared",
            "relative_attention_bias_weight": "relative_attention_bias"
            }.get(key, key)


def load_t5(module: nn.Module, params: Mapping) -> nn.Module:
    return load_from_jax(module, params, rename=t5_jax_name)
