"""Fused GroupNorm(+SiLU): kernel K2 of the port.

`group_norm_silu` is the wrapper of the hand-written Hopper kernel in
csrc/groupnorm.cu, which replaces the Pallas TPU kernel of
cremage_tpu/ops/groupnorm.py (`_gn_pallas`, `_gn_kernel`). On a CUDA
tensor it launches the kernel or raises; on a CPU tensor it runs
`group_norm_silu_reference`, the plain PyTorch version of the same
function, which the tests and chip_smoke.py also call directly.

Both compute fp32 one-pass moments with the variance clamped at 0, then
an fp32 epilogue y = x * (rstd * w) + (b - mean * rstd * w) (+ SiLU),
rounded once to the input dtype, as the Pallas body does. In fp32 this is
the JAX XLA path's arithmetic; under bf16 the XLA path runs its epilogue
in bf16 instead.
"""
from __future__ import annotations

import math

import torch

# elements of one (batch, group) slab that one block of the kernel handles
_CHUNK_TARGET = 16384


def group_norm_silu_reference(x: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor, groups: int = 32,
                              eps: float = 1e-5,
                              silu: bool = True) -> torch.Tensor:
    """Plain version. x: (N, C, ...) -> same shape and dtype."""
    n, c = x.shape[:2]
    xf = x.float().reshape(n, groups, -1)
    count = xf.shape[-1]
    mean = xf.sum(-1) / count
    var = torch.clamp((xf * xf).sum(-1) / count - mean * mean, min=0.0)
    rstd = torch.rsqrt(var + eps)
    cg = c // groups
    scale = rstd.repeat_interleave(cg, dim=1) * weight.float()
    shift = bias.float() - mean.repeat_interleave(cg, dim=1) * scale
    bshape = (n, c) + (1,) * (x.ndim - 2)
    y = x.float() * scale.reshape(bshape) + shift.reshape(bshape)
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def plan_chunks(slab: int) -> tuple:
    """(n_chunks, chunk): split one slab into chunks of a multiple of 8
    elements, about _CHUNK_TARGET each."""
    n_chunks = max(1, math.ceil(slab / _CHUNK_TARGET))
    chunk = -(-math.ceil(slab / n_chunks) // 8) * 8
    return math.ceil(slab / chunk), chunk


def check_kernel_inputs(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, groups: int) -> None:
    """Raise unless the inputs are what the CUDA kernel takes."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm_silu kernel takes bf16, got {x.dtype}")
    if x.ndim < 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_silu kernel takes a contiguous, 16-byte "
                         "aligned (N, C, H, W) tensor")
    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    if c % groups or hw % 8 or n * groups > 65535:
        raise ValueError(f"group_norm_silu kernel: C={c} must divide into "
                         f"{groups} groups, H*W={hw} must be a multiple of 8")
    for p in (weight, bias):
        if p.dtype != torch.float32 or p.shape != (c,) \
                or not p.is_contiguous() or p.device != x.device:
            raise ValueError("group_norm_silu kernel takes fp32 contiguous "
                             f"(C,) weight and bias on {x.device}")


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """x: (N, C, H, W), bf16 on the card; weight, bias: fp32 (C,). Returns
    x's shape/dtype.

    `group_norm_silu.launches` counts the kernel launches."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    check_kernel_inputs(x, weight, bias, groups)
    from cremage_tpu_torch.ops.build import check, kernels

    n, c = x.shape[:2]
    hw = x[0, 0].numel()
    n_chunks, chunk = plan_chunks(c // groups * hw)
    partial = torch.empty((n * groups * n_chunks, 2), dtype=torch.float32,
                          device=x.device)
    out = torch.empty_like(x)
    err = kernels().cremage_group_norm_silu_bf16(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
        partial.data_ptr(), n, c, hw, groups, n_chunks, chunk, float(eps),
        int(silu), torch.cuda.current_stream(x.device).cuda_stream)
    check(err, "group_norm_silu kernel launch")
    group_norm_silu.launches += 1
    return out


group_norm_silu.launches = 0
