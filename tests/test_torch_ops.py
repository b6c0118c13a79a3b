"""The port's two kernels (cremage_tpu_torch/ops) against the JAX package.

On the CPU each wrapper runs its plain PyTorch version; those are held
against both JAX paths of the same function: the XLA reference and the
Pallas kernel in interpret mode. Inputs are float32 from numpy seeds;
the CPU tolerances are float32 summation-order noise (1e-5 on O(1)
values). The `cuda` cases hold each CUDA kernel against its plain version
on the card and skip here; JAX is imported inside the parity tests so that
they also run where jax is not installed:
`python -m pytest --noconftest tests/test_torch_ops.py -m cuda`.
"""
import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from cremage_tpu_torch.ops.attention import attention
from cremage_tpu_torch.ops.flash_attention import (
    SMEM_LIMIT, SWIZZLE_BYTES, check_kernel_inputs as check_fa_inputs,
    flash_attention, flash_attention_reference, plan_flash,
)
from cremage_tpu_torch.ops import groupnorm as GN
from cremage_tpu_torch.ops.groupnorm import (
    check_kernel_inputs as check_gn_inputs, group_norm_silu,
    group_norm_silu_reference, plan_chunks, plan_groupnorm,
)

torch.set_num_threads(2)

ATOL = RTOL = 1e-5


def _qkv(seed, b, nq, nk, h, d):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, n, h, d).astype(np.float32) for n in (nq, nk, nk)]


@pytest.mark.parametrize("d,nk,scale", [(8, 77, None), (40, 77, None),
                                        (80, 130, None), (40, 77, 0.05)])
def test_flash_reference_matches_jax(d, nk, scale):
    import jax.numpy as jnp
    from cremage_tpu.ops.attention import dot_product_attention_xla
    from cremage_tpu.ops.flash_attention import flash_attention as jax_flash

    q, k, v = _qkv(d + nk, 2, 100, nk, 2, d)
    got = flash_attention_reference(*map(torch.from_numpy, (q, k, v)), scale)
    xla = dot_product_attention_xla(*map(jnp.asarray, (q, k, v)), scale=scale)
    pallas = jax_flash(*map(jnp.asarray, (q, k, v)), scale=scale,
                       interpret=True, bq=128, bk=128)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL,
                               rtol=RTOL)
    # on a CPU tensor the wrapper is the plain version
    np.testing.assert_array_equal(
        flash_attention(*map(torch.from_numpy, (q, k, v)), scale=scale).numpy(),
        got.numpy())


def test_flash_reference_matches_jax_at_d64():
    """The safety checker's head dim, at its 257 tokens."""
    import jax.numpy as jnp
    from cremage_tpu.ops.attention import dot_product_attention_xla

    q, k, v = _qkv(64, 1, 257, 257, 4, 64)
    got = flash_attention_reference(*map(torch.from_numpy, (q, k, v)))
    want = dot_product_attention_xla(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_masked_reference_matches_jax():
    import jax.numpy as jnp
    from cremage_tpu.ops.attention import dot_product_attention_xla

    q, k, v = _qkv(3, 2, 77, 77, 4, 8)
    mask = np.tril(np.ones((77, 77), bool))[None, None]
    got = attention(*map(torch.from_numpy, (q, k, v)),
                    mask=torch.from_numpy(mask))
    want = dot_product_attention_xla(*map(jnp.asarray, (q, k, v)),
                                     mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_flash_kernel_input_checks():
    q = torch.zeros(1, 4, 2, 40, dtype=torch.bfloat16)
    check_fa_inputs(q, q, q)
    with pytest.raises(TypeError):
        check_fa_inputs(q.float(), q.float(), q.float())
    for d in (8, 36):   # only the main path's head dims are instantiated
        bad_d = torch.zeros(1, 4, 2, d, dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="head dim"):
            check_fa_inputs(bad_d, bad_d, bad_d)
    with pytest.raises(ValueError, match="contiguous"):
        t = q.transpose(1, 2)
        check_fa_inputs(t, t, t)
    with pytest.raises(ValueError, match="aligned"):
        t = torch.zeros(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
        check_fa_inputs(t, t, t)


# every (Nq, Nk, d) of the main path: UNet self- and cross-attention at
# 64^2..8^2 latents, the VAE mid-block
MAIN_PATH_NQ_NK_D = [(4096, 4096, 40), (4096, 77, 40), (1024, 1024, 80),
                     (1024, 77, 80), (256, 256, 160), (256, 77, 160),
                     (64, 64, 160), (64, 77, 160), (4096, 4096, 512)]
# the new paths' shapes: the VAE encoder at 512^2 is (4096, 4096, 512) above;
# the hires fix's UNet and VAE at 96^2 and 128^2 latents (x1.5, x2)
HIRES_NQ_NK_D = [(9216, 9216, 40), (9216, 77, 40), (2304, 2304, 80),
                 (2304, 77, 80), (576, 576, 160), (576, 77, 160),
                 (144, 144, 160), (144, 77, 160), (9216, 9216, 512),
                 (16384, 16384, 40), (16384, 77, 40), (4096, 4096, 80),
                 (4096, 77, 80), (1024, 1024, 160), (1024, 77, 160),
                 (16384, 16384, 512)]
# the image safety checker's CLIP ViT-L/14 tower: 257 tokens at d = 64
SAFETY_NQ_NK_D = [(257, 257, 64)]
ALL_NQ_NK_D = MAIN_PATH_NQ_NK_D + HIRES_NQ_NK_D + SAFETY_NQ_NK_D


@pytest.mark.parametrize("nq,nk,d", ALL_NQ_NK_D)
def test_flash_plan_fits_shared_memory(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.stages >= 2          # the ring needs a stage to fill ahead
    assert plan.q_bufs in (1, 2)
    tiles = plan.q_bufs * plan.q_box[2] + plan.stages * 2 * plan.kv_box[2]
    assert plan.smem_bytes >= tiles * plan.dp * 2   # q and every K/V stage


@pytest.mark.parametrize("nq,nk,d", ALL_NQ_NK_D)
def test_flash_plan_tma_boxes(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    for box in (plan.q_box, plan.kv_box, plan.o_box):
        inner_bytes = box[0] * 2
        assert inner_bytes % 16 == 0 and inner_bytes <= SWIZZLE_BYTES
        assert all(1 <= n <= 256 for n in box)   # TMA's limit per box dim
        assert plan.dp % box[0] == 0             # whole boxes cover dp
    assert plan.q_box[2] == plan.bq and plan.kv_box[2] == plan.bk
    assert plan.q_blocks * plan.bq >= nq > (plan.q_blocks - 1) * plan.bq


@pytest.mark.parametrize("nq,nk,d", ALL_NQ_NK_D)
def test_flash_plan_key_tile(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    assert plan.bk % 8 == 0 and plan.bk <= 256   # a wgmma N
    assert plan.bk % 16 == 0                     # whole k16 steps of P V
    if nk <= 80:                                 # one tile, no rescale
        assert plan.bk >= nk


@pytest.mark.parametrize("nq,nk,d", ALL_NQ_NK_D)
def test_flash_plan_output_split_covers_d_once(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    cols = [c for lo, hi in plan.out_cols for c in range(lo, hi)]
    assert sorted(cols) == list(range(plan.dp)) and len(plan.out_cols) == plan.split
    assert plan.dp >= d and plan.dp % 16 == 0
    # a warpgroup's fp32 O: 64 rows x its columns over 128 threads
    assert all((hi - lo) // 2 <= 128 for lo, hi in plan.out_cols)


@pytest.mark.parametrize("nq,nk,d", ALL_NQ_NK_D + [(300, 4096, 40),
                                                         (100, 130, 80),
                                                         (64, 64, 80)])
def test_flash_plan_is_an_instantiation_of_the_kernel(nq, nk, d):
    """The C entry point dispatches on (dp, bk, split, nwg): the plan must
    name one of its cases."""
    src = (Path(__file__).resolve().parent.parent / "cremage_tpu_torch"
           / "csrc" / "flash_attention.cu").read_text()
    cases = set(re.findall(r"launch<Plan<(\d+), (\d+), (\d+), (\d+)>>", src))
    plan = plan_flash(d, nq, nk)
    assert plan.bq == 64 * plan.nwg // plan.split
    assert tuple(map(str, (plan.dp, plan.bk, plan.split, plan.nwg))) in cases


def _gn_inputs(seed, n, h, c, mean=0.0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, h, h, c) * 2.0 + mean).astype(np.float32)   # NHWC
    w = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    return x, w, b


def _jax_gn_pallas(x, w, b, eps, silu):
    """The Pallas body, run in interpret mode as the JAX package's own test
    runs it (tests/test_groupnorm_kernel.py)."""
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from cremage_tpu.ops import groupnorm as JG

    orig = pl.pallas_call
    try:
        pl.pallas_call = functools.partial(orig, interpret=True)
        n, h, _, c = x.shape
        out = JG._gn_pallas.__wrapped__(jnp.asarray(x).reshape(n, h * h, c),
                                        jnp.asarray(w), jnp.asarray(b), 32,
                                        eps, silu)
    finally:
        pl.pallas_call = orig
    return np.asarray(out).reshape(x.shape)


@pytest.mark.parametrize("eps,silu,mean,tol", [
    (1e-5, True, 0.0, 1e-5),
    (1e-6, False, 0.0, 1e-5),
    (1e-6, True, 0.0, 1e-5),
    # |mean| >> std: one-pass moments cancel; both sides sum 4096-element
    # groups in different orders, so the variance carries ~1e-7 * mean^2
    # relative error: 400 * 1e-7 / std^2(4) ~ 1e-5, amplified by 1/var
    (1e-5, True, 20.0, 1e-3),
])
def test_groupnorm_reference_matches_jax(eps, silu, mean, tol):
    import jax.numpy as jnp
    from cremage_tpu.ops import groupnorm as JG

    x, w, b = _gn_inputs(7, 2, 16, 64 if mean else 128, mean)
    got = group_norm_silu_reference(
        torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(w),
        torch.from_numpy(b), 32, eps, silu).permute(0, 2, 3, 1).numpy()
    xla = JG.group_norm_silu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             groups=32, eps=eps, silu=silu)
    np.testing.assert_allclose(got, np.asarray(xla), atol=tol, rtol=tol)
    np.testing.assert_allclose(got, _jax_gn_pallas(x, w, b, eps, silu),
                               atol=tol, rtol=tol)


def test_groupnorm_wrapper_on_cpu_is_the_reference():
    x, w, b = _gn_inputs(1, 2, 8, 64)
    args = (torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(w), torch.from_numpy(b), 32, 1e-6, True)
    np.testing.assert_array_equal(group_norm_silu(*args).numpy(),
                                  group_norm_silu_reference(*args).numpy())


def test_groupnorm_kernel_input_checks():
    x = torch.zeros(2, 64, 4, 4, dtype=torch.bfloat16)
    w = torch.ones(64)
    check_gn_inputs(x, w, w, 32)
    with pytest.raises(TypeError, match="bf16"):
        check_gn_inputs(x.float(), w, w, 32)
    # any H*W >= 1 (the kernels' other instantiation), none empty
    check_gn_inputs(torch.zeros(2, 64, 3, 3, dtype=torch.bfloat16), w, w, 32)
    with pytest.raises(ValueError, match="positive"):
        empty = torch.zeros(2, 64, 0, 3, dtype=torch.bfloat16)
        check_gn_inputs(empty, w, w, 32)
    with pytest.raises(ValueError, match="weight and bias"):
        check_gn_inputs(x, w.bfloat16(), w, 32)


@pytest.mark.parametrize("slab", [64, 2560, 40960, 512 * 512 * 8, 1000 * 8])
def test_groupnorm_chunk_plan_covers_slab(slab):
    n_chunks, chunk = plan_chunks(slab)
    assert chunk % 8 == 0 and n_chunks * chunk >= slab
    assert (n_chunks - 1) * chunk < slab          # no empty chunk


# every (N, C, H, W) of K2 on the main path: the UNet at the CFG batch of 8
# (64^2..8^2 latents), the VAE decoder at batch 4
MAIN_PATH_GN = [(8, 320, 64, 64), (8, 640, 64, 64), (8, 960, 64, 64),
                (8, 320, 32, 32), (8, 640, 32, 32), (8, 960, 32, 32),
                (8, 1280, 32, 32), (8, 1920, 32, 32), (8, 640, 16, 16),
                (8, 1280, 16, 16), (8, 1920, 16, 16), (8, 2560, 16, 16),
                (8, 1280, 8, 8), (8, 2560, 8, 8), (4, 512, 64, 64),
                (4, 512, 128, 128), (4, 512, 256, 256), (4, 256, 256, 256),
                (4, 256, 512, 512), (4, 128, 512, 512)]
# the new paths: the VAE encoder at batch 1 (512^2 and 1024^2), the hires
# decoder at 768^2 (batch 2) and 1024^2 (batch 1): slabs of 128 KB-16 MB
NEW_PATH_GN = [(1, 128, 512, 512), (1, 128, 256, 256), (1, 256, 256, 256),
               (1, 256, 128, 128), (1, 512, 128, 128), (1, 512, 64, 64),
               (1, 128, 1024, 1024), (1, 256, 512, 512), (1, 512, 256, 256),
               (2, 512, 96, 96), (2, 512, 192, 192), (2, 512, 384, 384),
               (2, 256, 384, 384), (2, 256, 768, 768), (2, 128, 768, 768),
               (1, 512, 512, 512), (1, 256, 1024, 1024)]
# edge cases: H*W = 8; a slab not divisible by 8 * k (a short last piece);
# N * G = 65535, the grid's y limit
EDGE_GN = [(2, 64, 1, 8), (2, 96, 61, 136), (65535, 1, 1, 64)]
# H*W not a multiple of 8: SD1.5 at 640^2 (10x10), 576^2 (18x18, 9x9) and
# SDXL at 832x1216 (26x38, with the output blocks' 2560 and 1920
# channels); slabs that start off a 16-byte boundary (C/G * H*W % 8 != 0:
# 640 channels at 9x9, odd slabs of 3 and 5 channels, one of them over a
# cluster of 4); H*W < 8 (2x3, 1x1); a two-pass slab of 5 odd channels
ANY_HW_GN = [(8, 1280, 10, 10), (8, 640, 18, 18), (8, 1280, 9, 9),
             (2, 1280, 26, 38), (2, 2560, 26, 38), (2, 1920, 26, 38),
             (8, 640, 9, 9), (2, 96, 9, 9), (2, 160, 181, 183),
             (2, 64, 2, 3), (3, 96, 1, 1), (2, 160, 700, 701)]


def _gn_plan(n, c, h, w, **kw):
    return plan_groupnorm(n, c, h * w, 32 if c % 32 == 0 else 1, **kw)


@pytest.mark.parametrize("n,c,h,w", MAIN_PATH_GN + NEW_PATH_GN + EDGE_GN)
def test_groupnorm_plan_covers_slab_once(n, c, h, w):
    plan = _gn_plan(n, c, h, w)
    pieces = plan.pieces()
    assert len(pieces) == plan.ctas
    assert pieces[0][0] == 0 and pieces[-1][1] == plan.slab
    assert all(e0 == b1 for (_, e0), (b1, _) in zip(pieces, pieces[1:]))
    assert all(b < e for b, e in pieces)                  # none empty
    # 16-byte boundaries, and each 8-vector in one channel plane: pieces
    # start at multiples of 8 elements and planes are H*W % 8 == 0 long
    assert plan.piece % 8 == 0 and (h * w) % 8 == 0
    assert all(b % 8 == 0 and (e - b) % 8 == 0 for b, e in pieces)
    if plan.route == "cluster":
        assert plan.sub % 8 == 0 and 1 <= -(-plan.piece // plan.sub) <= GN.MAX_SUB


@pytest.mark.parametrize("n,c,h,w", MAIN_PATH_GN + NEW_PATH_GN + EDGE_GN)
def test_groupnorm_plan_fits_a_cta(n, c, h, w):
    plan = _gn_plan(n, c, h, w)
    assert plan.cluster in GN.CLUSTER_SIZES
    assert plan.bytes_per_cta <= 227 * 1024
    if plan.route == "cluster":
        table = 8 * (plan.slab // (h * w))
        assert plan.smem_bytes == plan.bytes_per_cta + table
        assert plan.smem_bytes <= GN.SMEM_LIMIT - GN.STATIC_SMEM_SLACK
        # the smallest cluster that fits the target, or 16
        smaller = [k for k in GN.CLUSTER_SIZES if k < plan.cluster]
        assert all(2 * (-(-plan.slab // (8 * k)) * 8) > GN.PIECE_TARGET
                   for k in smaller)


@pytest.mark.parametrize("n,c,h,w", ANY_HW_GN)
def test_groupnorm_plan_takes_any_hw(n, c, h, w):
    """H*W % 8 != 0: the plan of the kernels' other instantiation covers
    each slab once with pieces of a multiple of 8 elements, and a CTA holds
    its piece in aligned coordinates (up to 7 elements before and after
    it) beside the channel table."""
    plan = _gn_plan(n, c, h, w)
    assert not plan.aligned and plan.slab == c // 32 * h * w
    pieces = plan.pieces()
    assert pieces[0][0] == 0 and pieces[-1][1] == plan.slab
    assert all(e0 == b1 for (_, e0), (b1, _) in zip(pieces, pieces[1:]))
    assert all(b < e for b, e in pieces) and plan.piece % 8 == 0
    table = 8 * (c // 32)
    if plan.route == "cluster":
        assert plan.smem_bytes == 2 * (plan.piece + 16) + table
        assert plan.smem_bytes <= GN.SMEM_LIMIT - GN.STATIC_SMEM_SLACK
        assert 1 <= -(-plan.piece // plan.sub) <= GN.MAX_SUB
        # the smallest cluster that fits the target, as for aligned slabs
        smaller = [k for k in GN.CLUSTER_SIZES if k < plan.cluster]
        assert all(2 * (-(-plan.slab // (8 * k)) * 8) > GN.PIECE_TARGET
                   for k in smaller)
    else:
        assert plan.smem_bytes == table and plan.piece <= 16384
    # the slab starts this plan's CTAs see: off 16-byte boundaries where
    # C/G * H*W % 8 != 0
    starts = {(i * plan.slab + b) % 8 for i in range(n) for b, _ in pieces}
    assert (starts != {0}) == bool(plan.slab % 8)


def test_groupnorm_any_hw_cases_cover_the_routes():
    plans = [_gn_plan(n, c, h, w) for n, c, h, w in ANY_HW_GN]
    assert {p.route for p in plans} == {"cluster", "two_pass"}
    assert any(p.route == "cluster" and p.cluster > 1 and p.slab % 8
               for p in plans)                   # misaligned, several CTAs
    assert any(p.route == "two_pass" and p.slab % 8 for p in plans)
    assert any(p.slab < 8 for p in plans)       # a piece below 8 elements


@pytest.mark.parametrize("n,c,h,w", MAIN_PATH_GN)
def test_groupnorm_plan_route(n, c, h, w):
    """One pass over a cluster-resident slab everywhere but the VAE's 4 MB
    slab, which no 16-CTA cluster holds."""
    want = "two_pass" if (n, c, h, w) == (4, 256, 512, 512) else "cluster"
    assert _gn_plan(n, c, h, w).route == want


@pytest.mark.parametrize("n,c,h,w", NEW_PATH_GN)
def test_groupnorm_new_path_route(n, c, h, w):
    """Slabs up to 16 CTAs of 225 KB (3.6 MB; the 512^2 encoder's largest
    is 2 MB) stay one pass in a cluster; the hires decoder's and the 1024^2
    encoder's 4-16 MB slabs take the two-pass route, at most 1024 chunks of
    16K elements."""
    plan = _gn_plan(n, c, h, w)
    one_pass = 2 * plan.slab <= 16 * 225 * 1024
    assert plan.route == ("cluster" if one_pass else "two_pass")
    if plan.route == "two_pass":
        assert plan.ctas <= 1024 and plan.piece <= 16384


def test_groupnorm_plan_matches_kernel_constants():
    src = (Path(__file__).resolve().parent.parent / "cremage_tpu_torch"
           / "csrc" / "groupnorm.cu").read_text()
    assert f"kMaxSub = {GN.MAX_SUB};" in src
    assert f"kSmemLimit = {GN.SMEM_LIMIT};" in src


def test_groupnorm_kernel_accepts_the_grid_limit():
    w = torch.ones(1)
    check_gn_inputs(torch.zeros(65535, 1, 1, 8, dtype=torch.bfloat16), w, w, 1)
    with pytest.raises(ValueError, match="groups"):
        check_gn_inputs(torch.zeros(65536, 1, 1, 8, dtype=torch.bfloat16), w, w, 1)


def _gn_partitioned(x, w, b, groups, eps, silu, plan):
    """The cluster route's arithmetic in plain PyTorch: each slab summed in
    fp32 piece by piece (each piece sub-chunk by sub-chunk) in the plan's
    order, the k partials combined in rank order, then one (scale, shift)
    per channel plane."""
    n, c = x.shape[:2]
    xs = x.float().reshape(n * groups, plan.slab)
    s = ss = 0.0
    for lo, hi in plan.pieces():
        ps = pss = 0.0
        for a in range(lo, hi, plan.sub or plan.piece):
            v = xs[:, a:min(a + (plan.sub or plan.piece), hi)]
            ps, pss = ps + v.sum(-1), pss + (v * v).sum(-1)
        s, ss = s + ps, ss + pss
    mean = s / plan.slab
    rstd = torch.rsqrt(torch.clamp(ss / plan.slab - mean * mean, min=0.0) + eps)
    cg = c // groups
    sc = rstd.reshape(n, groups, 1) * w.float().reshape(1, groups, cg)
    sh = b.float().reshape(1, groups, cg) - mean.reshape(n, groups, 1) * sc
    y = xs.reshape(n, c, -1) * sc.reshape(n, c, 1) + sh.reshape(n, c, 1)
    if silu:
        y = y * torch.sigmoid(y)
    return y.reshape(x.shape)


# (N, C, H, W): slabs of 3 channels x 808 (2424 elements, not a multiple of
# 8 * 16, so the last piece is short) and of one 16384-element channel (two
# sub-chunks)
@pytest.mark.parametrize("shape,k", [((2, 96, 8, 101), k) for k in
                                     GN.CLUSTER_SIZES] + [((1, 32, 128, 128), 1)])
@pytest.mark.parametrize("eps,silu", [(1e-5, True), (1e-6, False)])
def test_groupnorm_partitioned_reference(shape, k, eps, silu):
    n, c, h, w = shape
    slab = c // 32 * h * w
    plan = plan_groupnorm(n, c, h * w, 32, target=2 * (-(-slab // (8 * k)) * 8))
    assert plan.route == "cluster" and plan.cluster == k
    rng = np.random.RandomState(k)
    x = torch.from_numpy((rng.randn(*shape) * 2 + 1).astype(np.float32))
    wt, bt = (torch.from_numpy(rng.randn(c).astype(np.float32)) for _ in "wb")
    np.testing.assert_allclose(
        _gn_partitioned(x, wt, bt, 32, eps, silu, plan).numpy(),
        group_norm_silu_reference(x, wt, bt, 32, eps, silu).numpy(),
        atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,h,d", [(1, 200, 4096, 2, 40),
                                         (2, 300, 77, 4, 40),
                                         (2, 256, 256, 8, 80),
                                         (1, 64, 77, 8, 160),
                                         (1, 256, 256, 1, 512),
                                         # the K/V ring: fewer tiles than
                                         # stages, a ragged last tile, q rows
                                         # not a multiple of 128
                                         (2, 100, 64, 4, 80),
                                         (2, 100, 130, 4, 80),
                                         (1, 300, 4096, 2, 40),
                                         (8, 64, 64, 8, 160),
                                         (1, 1024, 1024, 1, 512),
                                         # the hires fix's longest loops: 512
                                         # K/V tiles an item at d = 512, and
                                         # 9216 tokens at d = 40
                                         (1, 16384, 16384, 1, 512),
                                         (2, 9216, 9216, 8, 40),
                                         # the safety checker's d = 64 at
                                         # its batch of 4 and of 1: ragged
                                         # key tiles (2 * 128 + 1) and a
                                         # second item of 65 q rows
                                         (4, 257, 257, 16, 64),
                                         (1, 257, 257, 16, 64)])
def test_flash_kernel_matches_plain(cuda, b, nq, nk, h, d):
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16)
               for a in _qkv(d, b, nq, nk, h, d))
    got = flash_attention(q, k, v)
    torch.cuda.synchronize()
    want = flash_attention_reference(q, k, v)
    # both round P to bf16 (unnormalized here, normalized in the plain
    # version) and the output once: a few bf16 ulps of the largest output
    tol = 2.0 ** -6 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


# (N, C, H, W, eps, silu, mean of x (std 2)) and the plan's route: every
# cluster size, a cluster of 16 beyond the piece target, the two-pass
# route, a short last piece, |mean| >> std
GN_CUDA_CASES = [
    (2, 320, 16, 16, 1e-5, True, 3.0, 1),
    (1, 128, 64, 64, 1e-6, False, 3.0, 1),
    (1, 640, 64, 64, 1e-5, False, 0.0, 2),
    (1, 960, 64, 64, 1e-6, True, 0.0, 4),
    (1, 512, 128, 128, 1e-5, True, 0.0, 8),
    (1, 256, 256, 256, 1e-6, True, 0.0, 16),
    (1, 128, 512, 512, 1e-6, False, 0.0, 16),
    (1, 256, 512, 512, 1e-6, True, 0.0, "two_pass"),
    (2, 96, 8, 2053, 1e-5, True, 3.0, 2),
    (1, 640, 64, 64, 1e-5, True, 20.0, 2),
    (8, 1280, 8, 8, 1e-6, False, 20.0, 1),
    (1, 256, 512, 512, 1e-5, False, 20.0, "two_pass"),
    # the new paths: the VAE encoder's N = 1 slabs (a partly filled card)
    # and the 1024^2 decoder's 16 MB slab
    (1, 512, 64, 64, 1e-6, True, 0.0, 2),
    (1, 256, 1024, 1024, 1e-6, True, 0.0, "two_pass"),
]


def test_groupnorm_cuda_cases_cover_the_plans():
    routes = []
    for n, c, h, w, _, _, _, want in GN_CUDA_CASES:
        plan = plan_groupnorm(n, c, h * w, 32)
        routes.append(plan.cluster if plan.route == "cluster" else plan.route)
        assert routes[-1] == want, (n, c, h, w)
    assert set(routes) == set(GN.CLUSTER_SIZES) | {"two_pass"}
    short = [plan_groupnorm(n, c, h * w, 32) for n, c, h, w, *_ in GN_CUDA_CASES]
    assert any(p.route == "cluster" and p.cluster > 1 and p.slab % p.piece
               for p in short)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("n,c,h,w", ANY_HW_GN)
def test_groupnorm_kernel_takes_any_hw(cuda, n, c, h, w, silu):
    """H*W % 8 != 0 on the card: the kernel, never the plain version or a
    library call, within one bf16 ulp of the plain version."""
    rng = np.random.RandomState(6)
    xt = torch.from_numpy((rng.randn(n, c, h, w) * 2.0 + 1.0).astype(
        np.float32)).to(cuda, torch.bfloat16)
    wt, bt = (torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
              for _ in "wb")
    before = group_norm_silu.launches
    got = group_norm_silu(xt, wt, bt, 32, 1e-5, silu)
    torch.cuda.synchronize()
    assert group_norm_silu.launches == before + 1
    want = group_norm_silu_reference(xt, wt, bt, 32, 1e-5, silu)
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** -7 * max(1.0, float(want.float().abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,w,eps,silu,mean,route", GN_CUDA_CASES)
def test_groupnorm_kernel_matches_plain(cuda, n, c, h, w, eps, silu, mean,
                                        route):
    rng = np.random.RandomState(5)
    xt = torch.from_numpy((rng.randn(n, c, h, w) * 2.0 + mean).astype(
        np.float32)).to(cuda, torch.bfloat16)
    wt, bt = (torch.from_numpy(rng.randn(c).astype(np.float32)).to(cuda)
              for _ in "wb")
    got = group_norm_silu(xt, wt, bt, 32, eps, silu)
    torch.cuda.synchronize()
    want = group_norm_silu_reference(xt, wt, bt, 32, eps, silu)
    # the statistics' summation order and the kernel's sigmoid
    # (tanh.approx) differ: one bf16 ulp of the largest output
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** -7 * max(1.0, float(want.float().abs().max()))
