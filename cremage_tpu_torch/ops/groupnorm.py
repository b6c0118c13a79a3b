"""Fused GroupNorm(+SiLU): kernel K2 of the port.

`group_norm_silu` is the wrapper of the hand-written Hopper kernels in
csrc/groupnorm.cu, which replace the Pallas TPU kernel of
cremage_tpu/ops/groupnorm.py (`_gn_pallas`, `_gn_kernel`). On a CUDA
tensor it launches a kernel or raises; on a CPU tensor it runs
`group_norm_silu_reference`, the plain PyTorch version of the same
function, which the tests and chip_smoke.py also call directly.

Both compute fp32 one-pass moments with the variance clamped at 0, then
an fp32 epilogue y = x * (rstd * w) + (b - mean * rstd * w) (+ SiLU),
rounded once to the input dtype, as the Pallas body does. In fp32 this is
the JAX XLA path's arithmetic; under bf16 the XLA path runs its epilogue
in bf16 instead.

`plan_groupnorm` decides from the shape alone how the kernels cover each
(batch, group) slab: one pass over a slab held in a thread-block
cluster's shared memory, or, for slabs beyond a 16-CTA cluster, two
passes with a split reduction. Any H*W is taken: where H*W is not a
multiple of 8 the kernels run their other instantiation, which reads and
writes the ends of each piece element by element (csrc/groupnorm.cu).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

SMEM_LIMIT = 232448        # shared memory one block can use on an H100
STATIC_SMEM_SLACK = 1024   # the cluster kernel's static shared memory fits in this
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# Bytes of its slab one CTA of the cluster route aims to hold: the smallest
# cluster whose pieces fit it is taken. Measured on the card over the
# main-path shapes (utils/groupnorm_sweep.py; PERF.md section 6).
PIECE_TARGET = 96 * 1024
SUB_BYTES = 16 * 1024      # each piece loads in sub-chunks of about this size,
MAX_SUB = 8                # at most this many (the kernel's kMaxSub)
# elements of one slab that one block of the two-pass route handles
_CHUNK_TARGET = 16384


@dataclasses.dataclass(frozen=True)
class GroupNormPlan:
    """How csrc/groupnorm.cu covers the slabs of one call."""
    route: str        # "cluster" (one pass) or "two_pass"
    ctas: int         # CTAs per slab: the cluster size, or the chunk count
    piece: int        # slab elements per CTA, a multiple of 8; the last
    #                   CTA's piece may be short
    sub: int          # cluster route: elements per sub-chunk (one mbarrier)
    smem_bytes: int   # dynamic shared memory per CTA
    slab: int         # elements of one (batch, group) slab
    aligned: bool = True  # H*W % 8 == 0: slabs and pieces start on 16-byte
    #                       boundaries and no 8-vector crosses a channel plane

    @property
    def cluster(self) -> int:
        return self.ctas if self.route == "cluster" else 1

    @property
    def bytes_per_cta(self) -> int:
        return 2 * self.piece

    def pieces(self) -> list:
        """[begin, end) of each CTA's piece of a slab, in rank order."""
        return [(r * self.piece, min((r + 1) * self.piece, self.slab))
                for r in range(self.ctas)]


def plan_chunks(slab: int) -> tuple:
    """(n_chunks, chunk): split one slab into chunks of a multiple of 8
    elements, about _CHUNK_TARGET each (the two-pass route)."""
    n_chunks = max(1, math.ceil(slab / _CHUNK_TARGET))
    chunk = -(-math.ceil(slab / n_chunks) // 8) * 8
    return math.ceil(slab / chunk), chunk


@functools.lru_cache(maxsize=None)
def plan_groupnorm(n: int, c: int, hw: int, groups: int,
                   target: int = PIECE_TARGET) -> GroupNormPlan:
    """The kernels' plan for x of shape (n, c, hw) in `groups` groups.

    The cluster route takes the smallest k in CLUSTER_SIZES whose pieces
    (ceil(slab / k) rounded up to 8 elements) fit `target` bytes, all k
    pieces non-empty; failing that the largest such k, if its piece and the
    channel table still fit a CTA's shared memory. Slabs beyond that take
    the two-pass route. Where H*W % 8 != 0 a piece is held in the aligned
    coordinates of x, 16 elements more. The plan does not depend on n."""
    if c % groups or hw <= 0:
        raise ValueError(f"group_norm_silu kernel: C={c} must divide into "
                         f"{groups} groups, H*W={hw} must be positive")
    slab = c // groups * hw
    table = 8 * (c // groups)
    aligned = hw % 8 == 0
    pad = 0 if aligned else 16

    def piece(k):
        return -(-slab // (8 * k)) * 8

    # every CTA of the cluster holds some of the slab
    sizes = [k for k in CLUSTER_SIZES if (k - 1) * piece(k) < slab]
    k = next((k for k in sizes if 2 * piece(k) <= target), sizes[-1])
    if 2 * (piece(k) + pad) + table <= SMEM_LIMIT - STATIC_SMEM_SLACK:
        p = piece(k)
        n_sub = min(MAX_SUB, max(1, -(-2 * p // SUB_BYTES)))
        return GroupNormPlan("cluster", k, p, -(-p // (8 * n_sub)) * 8,
                             2 * (p + pad) + table, slab, aligned)
    n_chunks, chunk = plan_chunks(slab)
    return GroupNormPlan("two_pass", n_chunks, chunk, 0, table, slab, aligned)


@functools.lru_cache(maxsize=None)
def active_clusters(plan: GroupNormPlan) -> int:
    """Clusters of the plan that the card holds at once
    (cudaOccupancyMaxActiveClusters); raises if none fits."""
    from cremage_tpu_torch.ops.build import check, kernels

    active = ctypes.c_int(0)
    check(kernels().cremage_gn_cluster_occupancy(
        plan.ctas, plan.smem_bytes, int(plan.aligned), ctypes.byref(active)),
        "group_norm_silu occupancy query")
    if active.value < 1:
        raise RuntimeError(f"group_norm_silu: no cluster of {plan.ctas} CTAs "
                           f"with {plan.smem_bytes} bytes each fits the card")
    return active.value


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


def check_kernel_inputs(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, groups: int) -> None:
    """Raise unless the inputs are what the CUDA kernel takes."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"group_norm_silu kernel takes bf16, got {x.dtype}")
    if x.ndim < 3 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("group_norm_silu kernel takes a contiguous, 16-byte "
                         "aligned (N, C, H, W) tensor")
    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    if c % groups or hw <= 0 or n * groups > 65535:
        raise ValueError(f"group_norm_silu kernel: C={c} must divide into "
                         f"{groups} groups (N * groups <= 65535), H*W={hw} "
                         "must be positive")
    for p in (weight, bias):
        if p.dtype != torch.float32 or p.shape != (c,) \
                or not p.is_contiguous() or p.device != x.device:
            raise ValueError("group_norm_silu kernel takes fp32 contiguous "
                             f"(C,) weight and bias on {x.device}")


def launch_plan(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                plan: GroupNormPlan, groups: int, eps: float,
                silu: bool) -> torch.Tensor:
    """Run the kernels on inputs that passed `check_kernel_inputs`, as
    `plan` (plan_groupnorm's for x's shape, or another target's) says."""
    from cremage_tpu_torch.ops.build import check, kernels

    n, c = x.shape[:2]
    hw = math.prod(x.shape[2:])
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if plan.route == "cluster":
        active_clusters(plan)
        err = kernels().cremage_gn_cluster_bf16(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            n, c, hw, groups, plan.ctas, plan.piece, plan.sub, plan.smem_bytes,
            float(eps), int(silu), stream)
    else:
        partial = torch.empty((n * groups * plan.ctas, 2), dtype=torch.float32,
                              device=x.device)
        err = kernels().cremage_gn_two_pass_bf16(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), out.data_ptr(),
            partial.data_ptr(), n, c, hw, groups, plan.ctas, plan.piece,
            float(eps), int(silu), stream)
    check(err, f"group_norm_silu {plan.route} kernel launch")
    group_norm_silu.launches += 1
    return out


def group_norm_silu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    groups: int = 32, eps: float = 1e-5,
                    silu: bool = True) -> torch.Tensor:
    """x: (N, C, H, W), bf16 on the card; weight, bias: fp32 (C,). Returns
    x's shape/dtype.

    `group_norm_silu.launches` counts the kernel launches (one per call,
    whichever route)."""
    if x.device.type == "cpu":
        return group_norm_silu_reference(x, weight, bias, groups, eps, silu)
    if x.device.type != "cuda":
        raise ValueError(f"group_norm_silu: unsupported device {x.device}")
    check_kernel_inputs(x, weight, bias, groups)
    plan = plan_groupnorm(x.shape[0], x.shape[1], math.prod(x.shape[2:]), groups)
    return launch_plan(x, weight, bias, plan, groups, eps, silu)


group_norm_silu.launches = 0
