"""Flash attention (forward, inference): kernel K1 of the port.

`flash_attention` is the wrapper of the hand-written Hopper kernel in
csrc/flash_attention.cu, which replaces the Pallas TPU kernel of
cremage_tpu/ops/flash_attention.py (`_flash_bhnd`, `_flash_kernel`). On a
CUDA tensor it launches the kernel or raises; on a CPU tensor it runs
`flash_attention_reference`, the plain PyTorch version of the same
function, which the tests and chip_smoke.py also call directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from cremage_tpu_torch.ops.attention import dot_product_attention

# padded head dims (round_up(d, 16)) the kernel is instantiated for: the
# main path's d = 40, 80, 160 (UNet) and 512 (VAE mid-block), and d = 64
# (the image safety checker's CLIP ViT-L/14 tower, 16 heads over 257 tokens;
# SDXL), d = 128 (FLUX's joint attention, 24 heads), and Hunyuan-DiT's
# d = 88 (as 96) and its attention pool's d = 256
SUPPORTED_PADDED_D = (48, 64, 80, 96, 128, 160, 256, 512)

SMEM_LIMIT = 232448   # shared memory one block can use on an H100
# the plain version computes at most this many bytes of fp32 logits at once
# (a (batch item, head group) at a time beyond it): the hires fix's 16,384
# tokens would need 17 GB for all 16 heads of one call at once
PLAIN_LOGIT_BYTES = 1 << 30
BOX_COLS = 16         # head-dim columns per TMA box: 32 bytes, the swizzle span
SWIZZLE_BYTES = 32
_ALIGN, _BARRIERS = 1024, 128   # the kernel's alignment slack and mbarriers


@dataclasses.dataclass(frozen=True)
class FlashPlan:
    """How csrc/flash_attention.cu runs one call (its
    `Plan<DP, BK, SPLIT, NWG>`)."""
    dp: int            # head dim padded to a multiple of 16
    bk: int            # keys per tile (wgmma N of Q K^T)
    split: int         # consumer warpgroups sharing one set of q rows
    nwg: int           # consumer warpgroups per block
    bq: int            # q rows per work item
    q_bufs: int        # q buffers (2: the next item's q loads during this one)
    stages: int        # K/V ring stages
    out_cols: tuple    # (first, last + 1) output columns of each of the
    #                    `split` warpgroups that share one set of q rows
    q_box: tuple       # TMA box {cols, heads, rows, batch} of q
    kv_box: tuple      # TMA box of k and v
    o_box: tuple       # TMA box of o (stored by each warpgroup)
    smem_bytes: int
    q_blocks: int      # work items per (batch, head); persistent blocks,
    #                    one per SM, walk over all B * H * q_blocks items

    @property
    def instantiation(self) -> str:
        return (f"flash_fwd_wgmma<Plan<{self.dp}, {self.bk}, {self.split}, "
                f"{self.nwg}>>")


def plan_flash(d: int, nq: int, nk: int) -> FlashPlan:
    """The kernel's launch plan for head dim d, nq queries and nk keys.

    The key tile fits the call: one 80-key tile up to 80 keys (the 77-key
    cross-attention, the 64-token self-attention), else 128; 32 at
    d = 512 and 64 at d = 256, where two warpgroups split the output
    columns over the same 64 q rows and the tiles must fit shared memory
    (Hunyuan-DiT's pool: one q row over 257 keys). Each consumer
    warpgroup owns 64 q rows (both share them at d = 512). q is
    double-buffered where two buffers fit beside a 2-stage ring; the ring
    has 3 stages where they fit and 2 otherwise."""
    dp = (d + 15) // 16 * 16
    if dp not in SUPPORTED_PADDED_D:
        raise ValueError(f"flash_attention kernel: head dim {d} unsupported")
    # three consumer warpgroups hide more of the wgmma and softmax latency
    # where their registers (160 a thread) hold O, S and P (up to dp = 96,
    # without spills); dp = 128 and up need two (240 a thread)
    nwg = 3 if dp <= 96 else 2
    if dp == 512:
        bk, split = 32, 2
    elif dp == 256:
        bk, split = 64, 2
    else:
        bk, split = (80 if nk <= 80 else 128), 1
    bq = 64 * nwg // split
    row_bytes = BOX_COLS * 2
    q_bytes = dp // BOX_COLS * bq * row_bytes
    kv_bytes = dp // BOX_COLS * bk * row_bytes

    def smem(q_bufs, stages):
        return _ALIGN + q_bufs * q_bytes + stages * 2 * kv_bytes + _BARRIERS

    q_bufs = 2 if smem(2, 2) <= SMEM_LIMIT else 1
    stages = 3 if smem(q_bufs, 3) <= SMEM_LIMIT else 2
    dv = dp // split
    return FlashPlan(
        dp=dp, bk=bk, split=split, nwg=nwg, bq=bq, q_bufs=q_bufs, stages=stages,
        out_cols=tuple((w * dv, (w + 1) * dv) for w in range(split)),
        q_box=(BOX_COLS, 1, bq, 1), kv_box=(BOX_COLS, 1, bk, 1),
        o_box=(BOX_COLS, 1, 64, 1),
        smem_bytes=smem(q_bufs, stages),
        q_blocks=-(-nq // bq))


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor,
                              scale: Optional[float] = None) -> torch.Tensor:
    """Plain version: unmasked fp32-softmax attention, probabilities cast
    to v's dtype before PV (cremage_tpu/ops/attention.py
    `dot_product_attention_xla` without a mask), over groups of heads of
    at most PLAIN_LOGIT_BYTES of logits."""
    b, nq, h, _ = q.shape
    per_head = 4 * nq * k.shape[1]
    if b * h * per_head <= PLAIN_LOGIT_BYTES:
        return dot_product_attention(q, k, v, scale=scale)
    out = torch.empty_like(q)
    hc = max(1, min(h, PLAIN_LOGIT_BYTES // per_head))
    for i in range(b):
        for h0 in range(0, h, hc):
            sl = (slice(i, i + 1), slice(None), slice(h0, h0 + hc))
            out[sl] = dot_product_attention(q[sl], k[sl], v[sl], scale=scale)
    return out


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

    `flash_attention.launches` counts the kernel launches, and
    `flash_attention.launches_by_dp` ({padded head dim: launches}) them by
    instantiation."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    check_kernel_inputs(q, k, v)
    from cremage_tpu_torch.ops.build import check, kernels

    b, nq, h, d = q.shape
    if scale is None:
        scale = d ** -0.5
    if not scale > 0:
        raise ValueError(f"flash_attention kernel: scale {scale} must be > 0")
    plan = plan_flash(d, nq, k.shape[1])
    out = torch.empty_like(q)
    err = kernels().cremage_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, nq,
        k.shape[1], d, float(scale), plan.dp, plan.bk, plan.bq, plan.stages,
        plan.split, plan.smem_bytes,
        torch.cuda.current_stream(q.device).cuda_stream)
    check(err, "flash_attention kernel launch")
    flash_attention.launches += 1
    by_dp = flash_attention.launches_by_dp
    by_dp[plan.dp] = by_dp.get(plan.dp, 0) + 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_dp = {}
