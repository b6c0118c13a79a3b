"""8-bit weight storage (the port of cremage_tpu/io/quantize.py).

A linear layer's weight is stored as float8_e4m3fn, float8_e5m2 or int8
codes with a per-output-channel float32 `weight_scale` buffer beside it
(quanto-qfloat8 semantics: W ~= W_q * s, s = max|W| over the row / qmax),
and models/layers.py `Linear8bit` applies the scale to the product's
output:
weight-only for the float8 kinds, w8a8 (activations quantized per token
at use) for int8.

Which weights: the 2-D `weight` of every `Linear` of at least `min_size`
elements whose dotted name (lowercased) holds none of DEFAULT_EXCLUDE
(the gather tables) and that is not already 8-bit, as JAX's
`should_quantize` decides over its parameter tree; with `include_convs`
(JAX's int8 storage of the DiTs) also the 4-D weight of each such
`Conv2d`, which must be a patch embedding (models/layers.py
`PatchConv8bit`: stride = kernel, no padding, a product over patches).
The UNets' int8 path (w8a8 3x3 convolutions) has no port: PyTorch has no
int8 convolution on CUDA, and the pipelines refuse
`unet_quantize="int8"`.

Quantizing happens on the device, tensor by tensor: `quantize_weight`
takes one weight in the dtype the model keeps its weights in, the
file's tensor converted to it (reduced in that dtype and divided in
float32, as JAX does over its parameters in their param dtype), so the
codes equal JAX's for the same file. `prepare_8bit` marks a module (on
the meta device) so that io/checkpoint.py `load_into` quantizes each of
its weights as it is loaded, and `quantize_module` quantizes a loaded
module in place (after a LoRA merge).

This module alone knows the storage format, apart from the product that
`Linear8bit` computes over it: `is_coded` tells 8-bit codes from a
weight in the compute dtype (models/layers.py `set_compute_dtype`),
`coded_weights` names the scales that loading derives
(io/checkpoint.py), `leaf_to_tensor` moves JAX's float8 leaves
(io/convert.py), and `unet_kind` is the one place that refuses int8
UNet storage.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

QUANT_DTYPES = {
    "float8_e4m3": (torch.float8_e4m3fn, 448.0),
    "float8_e5m2": (torch.float8_e5m2, 57344.0),
    "int8": (torch.int8, 127.0),
}
EIGHT_BIT = tuple(dt for dt, _ in QUANT_DTYPES.values())

# the gather-source embedding tables, as in JAX (matched by substring)
DEFAULT_EXCLUDE = ("token_embedding", "shared", "wte", "embed_tokens",
                   "word_embeddings")
MIN_SIZE = 65536
# numpy dtype names of JAX's 8-bit float leaves (ml_dtypes)
_NUMPY_FLOAT8 = {"float8_e4m3fn": torch.float8_e4m3fn,
                 "float8_e5m2": torch.float8_e5m2}


def check_dtype(dtype: str) -> str:
    if dtype not in QUANT_DTYPES:
        raise ValueError(f"8-bit storage {dtype!r} unknown: one of "
                         f"{sorted(QUANT_DTYPES)} or 'none'")
    return dtype


def unet_kind(kind: Optional[str]) -> Optional[str]:
    """The 8-bit kind of a `unet_quantize` option: None for None, "" and
    "none"; int8 is refused (JAX's int8 UNet storage also quantizes the
    convolutions, and PyTorch has no int8 convolution on CUDA)."""
    if kind in (None, "", "none"):
        return None
    if kind == "int8":
        raise NotImplementedError(
            "unet_quantize='int8' (w8a8 UNet convolutions) is not ported: "
            "PyTorch has no int8 convolution on CUDA; use float8_e4m3 or "
            "float8_e5m2")
    return check_dtype(kind)


def is_coded(t: torch.Tensor) -> bool:
    """Whether `t` holds 8-bit codes (with a `weight_scale` beside it)."""
    return t.dtype in EIGHT_BIT


def coded_weights(state: Dict[str, torch.Tensor]) -> Dict[str, str]:
    """{key of each 8-bit weight of a state dict: the key of its scale}."""
    return {k: k + "_scale" for k, t in state.items() if is_coded(t)}


def leaf_to_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """A JAX leaf as numpy -> a tensor of `dtype`; float8 codes (ml_dtypes,
    which torch cannot read) move bit for bit."""
    if arr.dtype.name not in _NUMPY_FLOAT8:
        return torch.from_numpy(arr).to(dtype)
    if _NUMPY_FLOAT8[arr.dtype.name] != dtype:
        raise TypeError(f"JAX {arr.dtype.name} codes, the port wants {dtype}")
    return torch.from_numpy(arr.view(np.uint8)).view(dtype)


def should_quantize(name: str, weight: torch.Tensor, *,
                    min_size: int = MIN_SIZE,
                    exclude: Tuple[str, ...] = DEFAULT_EXCLUDE,
                    include_convs: bool = False) -> bool:
    """A 2-D (with include_convs, also 4-D) floating `*.weight` of at
    least min_size elements, not yet 8-bit, whose name holds no exclude
    substring."""
    ndims = (2, 4) if include_convs else (2,)
    if weight.ndim not in ndims or weight.numel() < min_size:
        return False
    if not name.endswith("weight") or not weight.is_floating_point():
        return False
    if is_coded(weight):
        return False
    return not any(tok in name.lower() for tok in exclude)


def quantize_weight(w: torch.Tensor, dtype: str
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) or (out, in, kh, kw) weight -> (codes, float32 scale of
    each output channel):
    scale = max(max|w| / qmax, 1e-12), codes = w / scale in float32, cast
    (float8, round to nearest even) or rounded and clipped (int8)."""
    qdt, qmax = QUANT_DTYPES[check_dtype(dtype)]
    s = w.abs().amax(dim=tuple(range(1, w.ndim))).float()
    s = torch.clamp_min(s / qmax, 1e-12)
    q = w.float() / s.view((-1,) + (1,) * (w.ndim - 1))
    if not qdt.is_floating_point:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(qdt), s


def targets(module: nn.Module, min_size: int = MIN_SIZE,
            include_convs: bool = False) -> Dict[str, nn.Module]:
    """{dotted weight name: Linear or Conv2d} of the weights 8-bit storage
    takes (convolutions with include_convs only)."""
    from cremage_tpu_torch.models.layers import Conv2d, Linear

    kinds = (Linear, Conv2d) if include_convs else (Linear,)
    return {f"{name}.weight": m for name, m in module.named_modules()
            if isinstance(m, kinds) and should_quantize(
                f"{name}.weight", m.weight, min_size=min_size,
                include_convs=include_convs)}


def set_8bit(layer: nn.Module, codes: torch.Tensor,
             scale: torch.Tensor) -> None:
    """Store `codes` as the layer's weight and `scale` as its
    weight_scale buffer, and make the layer a models/layers.py
    `Linear8bit` (a Conv2d: `PatchConv8bit`, int8 only), whose forward
    takes them (a plain layer's forward stays free of the 8-bit
    branches)."""
    from cremage_tpu_torch.models.layers import Linear, Linear8bit, PatchConv8bit

    if not isinstance(layer, Linear) and codes.dtype != torch.int8:
        raise ValueError("8-bit convolutions are int8 only (JAX's Conv has "
                         "no float8 branch)")
    layer.weight = nn.Parameter(codes, requires_grad=False)
    layer.register_buffer("weight_scale", scale)
    layer.__class__ = Linear8bit if isinstance(layer, Linear) else PatchConv8bit


def prepare_8bit(module: nn.Module, dtype: str, min_size: int = MIN_SIZE,
                 include_convs: bool = False) -> int:
    """Give each target of `module` (on the meta device) an empty 8-bit
    weight and scale, so that io/checkpoint.py `load_into` quantizes it as
    it loads. -> the number of targets."""
    qdt, _ = QUANT_DTYPES[check_dtype(dtype)]
    found = targets(module, min_size, include_convs)
    for lin in found.values():
        w = lin.weight
        set_8bit(lin, torch.empty(w.shape, dtype=qdt, device=w.device),
                 torch.empty(w.shape[0], dtype=torch.float32, device=w.device))
    return len(found)


def quantize_module(module: nn.Module, dtype: str, min_size: int = MIN_SIZE,
                    include_convs: bool = False) -> dict:
    """Quantize the targets of a loaded module in place, one weight at a
    time. -> a report: tensors, bytes before and after, dtype."""
    report = {"tensors": 0, "bytes_before": 0, "bytes_after": 0,
              "dtype": check_dtype(dtype)}
    for lin in targets(module, min_size, include_convs).values():
        w = lin.weight.data
        report["tensors"] += 1
        report["bytes_before"] += w.numel() * w.element_size()
        report["bytes_after"] += w.numel() + 4 * w.shape[0]
        set_8bit(lin, *quantize_weight(w, dtype))
        del w
    return report


def storage_report(module: nn.Module, dtype: str) -> dict:
    """The report of quantize_module for a module already in 8 bits."""
    from cremage_tpu_torch.models.layers import Linear8bit, PatchConv8bit

    lins = [m for m in module.modules()
            if isinstance(m, (Linear8bit, PatchConv8bit))]
    return {"tensors": len(lins), "dtype": dtype,
            "bytes_after": sum(m.weight.numel() + 4 * m.weight.shape[0]
                               for m in lins)}
