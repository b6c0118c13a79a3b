"""Textual-inversion embedding files (the port of cremage_tpu/io/ti.py).

Formats: .pt (A1111 {'string_to_param': {'*': tensor}}), .bin (diffusers
{name: tensor}) and .safetensors; SDXL embeddings are dicts with
'clip_l' / 'clip_g' entries. `.safetensors` is read by the port's own
reader, everything else by `torch.load(weights_only=True)`.
"""
from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from cremage_tpu_torch.io.checkpoint import load_safetensors


def load_embedding(path: str) -> Union[np.ndarray, Dict[str, np.ndarray]]:
    """-> (n_tokens, dim) float32 array, or a dict of them for SDXL's
    two-tower embeddings."""
    if path.endswith(".safetensors"):
        return _normalize(load_safetensors(path))
    return _normalize(torch.load(path, map_location="cpu", weights_only=True))


def _to_np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().float().numpy()
    arr = np.asarray(t, dtype=np.float32)
    return arr[None, :] if arr.ndim == 1 else arr


def _normalize(obj):
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        return _to_np(obj)
    if isinstance(obj, dict):
        if "string_to_param" in obj:                  # A1111
            params = obj["string_to_param"]
            key = "*" if "*" in params else next(iter(params))
            return _to_np(params[key])
        lowered = {k.lower() for k in obj}
        if "clip_l" in lowered or "clip_g" in lowered:  # SDXL two towers
            return {k.lower(): _to_np(v) for k, v in obj.items()
                    if k.lower() in ("clip_l", "clip_g")}
        if "emb_params" in obj:
            return _to_np(obj["emb_params"])
        tensors = {k: v for k, v in obj.items()
                   if hasattr(v, "shape") and k != "name"}
        if len(tensors) == 1:                          # diffusers .bin
            return _to_np(next(iter(tensors.values())))
    raise ValueError(f"unrecognized embedding format: {type(obj)}")
