"""Flash attention (forward, inference): kernel K1 of the port.

`flash_attention` is the wrapper of the hand-written Hopper kernel in
csrc/flash_attention.cu, which replaces the Pallas TPU kernel of
cremage_tpu/ops/flash_attention.py (`_flash_bhnd`, `_flash_kernel`). On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
`flash_attention_reference`, the plain PyTorch version of the same
function, which the tests and chip_smoke.py also call directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from cremage_tpu_torch.ops.attention import dot_product_attention

# padded head dims (round_up(d, 16)) the kernel is instantiated for: the
# main path's d = 40, 80, 160 (UNet) and 512 (VAE mid-block)
SUPPORTED_PADDED_D = (48, 80, 160, 512)


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: unmasked fp32-softmax attention, probabilities cast
    to v's dtype before PV (cremage_tpu/ops/attention.py
    `dot_product_attention_xla` without a mask)."""
    return dot_product_attention(q, k, v, scale=scale)


def check_kernel_inputs(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> None:
    """Raise unless (q, k, v) are what the CUDA kernel takes."""
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_attention kernel takes bf16, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4 \
            or q.shape[0] != k.shape[0] or q.shape[2:] != k.shape[2:]:
        raise ValueError(f"flash_attention: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)} are not "
                         "(B, Nq, H, D), (B, Nk, H, D)")
    d = q.shape[-1]
    if d % 8 or (d + 15) // 16 * 16 not in SUPPORTED_PADDED_D:
        raise ValueError(f"flash_attention kernel: head dim {d} unsupported "
                         f"(d % 8 == 0 and round_up(d, 16) in "
                         f"{SUPPORTED_PADDED_D})")
    if q.shape[0] * q.shape[2] > 65535 or min(q.shape[1], k.shape[1]) < 1:
        raise ValueError("flash_attention kernel: B*H must be <= 65535 and "
                         "both sequences non-empty")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("flash_attention kernel takes contiguous, 16-byte "
                         "aligned tensors")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Nq, H, D), k, v: (B, Nk, H, D) -> (B, Nq, H, D).

    `flash_attention.launches` counts the kernel launches."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_kernel_inputs(q, k, v)
    from cremage_tpu_torch.ops.build import check, kernels

    b, nq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    err = kernels().cremage_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq,
        k.shape[1], d, float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention kernel launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
