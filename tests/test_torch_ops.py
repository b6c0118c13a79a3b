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
from cremage_tpu_torch.ops.groupnorm import (
    check_kernel_inputs as check_gn_inputs, group_norm_silu,
    group_norm_silu_reference, plan_chunks,
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


@pytest.mark.parametrize("nq,nk,d", MAIN_PATH_NQ_NK_D)
def test_flash_plan_fits_shared_memory(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    assert plan.smem_bytes <= SMEM_LIMIT
    assert plan.stages >= 2          # the ring needs a stage to fill ahead
    assert plan.q_bufs in (1, 2)
    tiles = plan.q_bufs * plan.q_box[2] + plan.stages * 2 * plan.kv_box[2]
    assert plan.smem_bytes >= tiles * plan.dp * 2   # q and every K/V stage


@pytest.mark.parametrize("nq,nk,d", MAIN_PATH_NQ_NK_D)
def test_flash_plan_tma_boxes(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    for box in (plan.q_box, plan.kv_box, plan.o_box):
        inner_bytes = box[0] * 2
        assert inner_bytes % 16 == 0 and inner_bytes <= SWIZZLE_BYTES
        assert all(1 <= n <= 256 for n in box)   # TMA's limit per box dim
        assert plan.dp % box[0] == 0             # whole boxes cover dp
    assert plan.q_box[2] == plan.bq and plan.kv_box[2] == plan.bk
    assert plan.q_blocks * plan.bq >= nq > (plan.q_blocks - 1) * plan.bq


@pytest.mark.parametrize("nq,nk,d", MAIN_PATH_NQ_NK_D)
def test_flash_plan_key_tile(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    assert plan.bk % 8 == 0 and plan.bk <= 256   # a wgmma N
    assert plan.bk % 16 == 0                     # whole k16 steps of P V
    if nk <= 80:                                 # one tile, no rescale
        assert plan.bk >= nk


@pytest.mark.parametrize("nq,nk,d", MAIN_PATH_NQ_NK_D)
def test_flash_plan_output_split_covers_d_once(nq, nk, d):
    plan = plan_flash(d, nq, nk)
    cols = [c for lo, hi in plan.out_cols for c in range(lo, hi)]
    assert sorted(cols) == list(range(plan.dp)) and len(plan.out_cols) == plan.split
    assert plan.dp >= d and plan.dp % 16 == 0
    # a warpgroup's fp32 O: 64 rows x its columns over 128 threads
    assert all((hi - lo) // 2 <= 128 for lo, hi in plan.out_cols)


@pytest.mark.parametrize("nq,nk,d", MAIN_PATH_NQ_NK_D + [(300, 4096, 40),
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
    with pytest.raises(ValueError, match="multiple of 8"):
        odd = torch.zeros(2, 64, 3, 3, dtype=torch.bfloat16)
        check_gn_inputs(odd, w, w, 32)
    with pytest.raises(ValueError, match="weight and bias"):
        check_gn_inputs(x, w.bfloat16(), w, 32)


@pytest.mark.parametrize("slab", [64, 2560, 40960, 512 * 512 * 8, 1000 * 8])
def test_groupnorm_chunk_plan_covers_slab(slab):
    n_chunks, chunk = plan_chunks(slab)
    assert chunk % 8 == 0 and n_chunks * chunk >= slab
    assert (n_chunks - 1) * chunk < slab          # no empty chunk


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
                                         (1, 1024, 1024, 1, 512)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,h,eps,silu", [(2, 320, 16, 1e-5, True),
                                            (1, 128, 64, 1e-6, False)])
def test_groupnorm_kernel_matches_plain(cuda, n, c, h, eps, silu):
    x, w, b = _gn_inputs(5, n, h, c, 3.0)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().to(
        cuda, torch.bfloat16)
    wt, bt = torch.from_numpy(w).to(cuda), torch.from_numpy(b).to(cuda)
    got = group_norm_silu(xt, wt, bt, 32, eps, silu)
    torch.cuda.synchronize()
    want = group_norm_silu_reference(xt, wt, bt, 32, eps, silu)
    # only the statistics' summation order differs: one bf16 output ulp
    assert float((got.float() - want.float()).abs().max()) <= \
        2.0 ** -7 * max(1.0, float(want.float().abs().max()))
