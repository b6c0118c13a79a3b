"""The samplers beyond the SD1.5 menu (PLMS, DPM Solver, LCM) and SDXL's
prediction guiders in the port against the JAX package's: each on an
analytic denoiser (JAX's samplers run under jax.disable_jit(), its guiders
eagerly), then SD1.5 generate() with each of PLMS, DPM Solver and LCM on
the tiny bundle of tests/test_torch_pipeline.py.

The port is handed the noise JAX draws from its keys (step i:
split(key, n)[i]). Everything is float32 on the CPU. Tolerances: the
samplers 1e-5 of the result's range (as tests/test_torch_samplers.py),
the guiders 1e-5 (as tests/test_torch_sdxl.py), generate() 2/255 beyond
one uint8 step (as tests/test_torch_pipeline.py::test_txt2img_matches_jax:
both round the latent to bf16 before the decode).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.core.config import GenerationOptions as JOptions
from cremage_tpu.samplers import ddim as JDDIM
from cremage_tpu.samplers import edm as JE
from cremage_tpu.samplers import lcm as JLCM
from cremage_tpu.samplers import ldm_extra as JLDMX
from cremage_tpu.samplers import schedules as JS
from cremage_tpu_torch.core.config import GenerationOptions
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.pipelines.sd15 import (
    EXTRA_SAMPLERS, SD15Pipeline, T_DRIVEN_SAMPLERS,
)
from cremage_tpu_torch.samplers import ddim as DDIM
from cremage_tpu_torch.samplers import edm as E
from cremage_tpu_torch.samplers import lcm as LCM
from cremage_tpu_torch.samplers import ldm_extra as LDMX
from tests.conftest import assert_img01_close
from tests.test_torch_pipeline import (  # noqa: F401
    OPTS, bundles, jax_noise, cheap_jax,
)
from tests.test_torch_samplers import SHAPE, jax_steps

torch.set_num_threads(2)
ACP = 1.0 / (1.0 + JS.default_sd_schedule().sigmas ** 2)


def eps_fn(lib):
    """An analytic stand-in for the CFG'd eps model: smooth in x and t."""
    return lambda x, t: 0.8 * lib.tanh(x) + 0.01 * lib.sin(lib.reshape(
        lib.asarray(t, dtype=lib.float32), (-1, 1, 1, 1)) / 100.0) - 0.02 * x


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.ptp(want)))


def x_init(seed=30):
    return np.asarray(jax.random.normal(jax.random.key(seed), SHAPE,
                                        jnp.float32))


def _net(lib):
    """An analytic network(x, t, cond) that reads its timestep and cond."""
    return lambda x, t, cond: (x * 0.3 + lib.sin(t / 100.0).reshape(-1, 1, 1, 1)
                               + cond["vector"][:, :1].reshape(-1, 1, 1, 1))


def test_prediction_guiders_match_jax():
    """Each frame of the batch guided by its own scale, as JAX's
    _frame_scaled_cfg; the SDXL pipeline passes num_frames 1."""
    for name in ("LinearPredictionGuider", "TrianglePredictionGuider"):
        for num_frames in (1, 3):
            _check_guider(name, num_frames)


def _check_guider(name, num_frames):
    table = E.LegacyDDPMDiscretization()(1000, do_append_zero=False)
    rng = np.random.RandomState(31)
    b = 2 * num_frames
    x = rng.randn(b, 4, 4, 4).astype(np.float32)
    c = {"vector": rng.randn(b, 8).astype(np.float32),
         "crossattn": rng.randn(b, 3, 8).astype(np.float32)}
    uc = {k: v * 0.5 for k, v in c.items()}
    kw = dict(scale=6.0, min_scale=1.5, max_scale=4.0, num_frames=num_frames)
    jg = {"LinearPredictionGuider": JE.linear_prediction_guider,
          "TrianglePredictionGuider": JE.triangle_prediction_guider}[name]
    jd = JE.DiscreteDenoiserSGM(_net(jnp), table)
    td = E.DiscreteDenoiserSGM(_net(torch), table)
    for sigma in (5.0, 0.5):
        want = jg(jd, {k: jnp.asarray(v) for k, v in c.items()},
                  {k: jnp.asarray(v) for k, v in uc.items()},
                  **kw)(jnp.asarray(x), sigma)
        got = E.GUIDERS[name](td, {k: torch.from_numpy(v) for k, v in c.items()},
                              {k: torch.from_numpy(v) for k, v in uc.items()},
                              **kw)(torch.from_numpy(x), sigma)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)
    if name == "TrianglePredictionGuider":    # other periods and fusings
        for extra in (dict(period=(0.5, 1.0), period_fusing="mean"),
                      dict(period=[0.4, 0.7], period_fusing="multiply")):
            want = jg(jd, {k: jnp.asarray(v) for k, v in c.items()},
                      {k: jnp.asarray(v) for k, v in uc.items()},
                      **kw, **extra)(jnp.asarray(x), 2.0)
            got = E.GUIDERS[name](
                td, {k: torch.from_numpy(v) for k, v in c.items()},
                {k: torch.from_numpy(v) for k, v in uc.items()},
                **kw, **extra)(torch.from_numpy(x), 2.0)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-5, rtol=1e-5)


def test_lcm_schedule_matches_jax():
    for acp in (ACP, E.LegacyDDPMDiscretization().alphas_cumprod):
        for steps, strength in ((1, 1.0), (4, 1.0), (8, 1.0), (50, 1.0),
                                (3, 0.75), (2, 0.3), (1, 0.01)):
            got = LCM.make_lcm_schedule(acp, steps, strength=strength)
            want = JLCM.make_lcm_schedule(acp, steps, strength=strength)
            for f in ("sigmas", "sigma_next", "c_skip", "c_out", "c_in",
                      "timesteps"):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f), f)
    for bad in (0, 51):
        with pytest.raises(ValueError, match="LCM steps"):
            LCM.make_lcm_schedule(ACP, bad)


def test_lcm_sampler_matches_jax():
    """A full run, a single step, and img2img's truncated grid."""
    den = lambda lib: (lambda x, s: x * (0.6 / (1.0 + s))
                       + 0.2 * lib.tanh(x) - 0.05)
    key = jax.random.key(32)
    for steps, strength in ((4, 1.0), (1, 1.0), (3, 0.6)):
        sched = LCM.make_lcm_schedule(ACP, steps, strength=strength)
        x = x_init() * float(sched.sigmas[0])
        with jax.disable_jit():
            want = JLCM.sample_lcm(den(jnp), jnp.asarray(x),
                                   JLCM.make_lcm_schedule(ACP, steps,
                                                          strength=strength),
                                   key=key)
        msgs = []
        got = LCM.sample_lcm(den(torch), torch.from_numpy(x), sched,
                             ArrayNoise(None, jax_steps(key, steps)),
                             progress_cb=msgs.append)
        close(got, want)
        assert msgs == list(range(steps))


def test_plms_matches_jax():
    """Step 0's pseudo improved Euler, then 2nd-4th order Adams-Bashforth;
    t_start: the img2img decode from that DDIM step."""
    x = x_init()
    for steps, t_start in ((5, None), (1, None), (6, 4), (4, 1)):
        jsched = JDDIM.make_ddim_schedule(ACP, steps, eta=0.0)
        with jax.disable_jit():
            want = JLDMX.sample_plms(eps_fn(jnp), jnp.asarray(x), jsched,
                                     t_start=t_start)
        msgs = []
        got = LDMX.sample_plms(eps_fn(torch), torch.from_numpy(x),
                               DDIM.make_ddim_schedule(ACP, steps, eta=0.0),
                               t_start=t_start, progress_cb=msgs.append)
        close(got, want)
        assert msgs == list(range(t_start or steps))
    with pytest.raises(ValueError, match="eta must be 0"):
        LDMX.sample_plms(eps_fn(torch), torch.from_numpy(x),
                         DDIM.make_ddim_schedule(ACP, 4, eta=0.5))


def test_dpm_solver_matches_jax():
    """Order 2 but on the first transition and, under 15 steps, the last."""
    x = x_init()
    for steps in (2, 5, 16):
        got_s = LDMX.make_dpm_solver_schedule(ACP, steps)
        want_s = JLDMX.make_dpm_solver_schedule(ACP, steps)
        for f in ("t_model", "alphas", "sigmas_vp", "A", "B", "C"):
            np.testing.assert_array_equal(getattr(got_s, f),
                                          getattr(want_s, f), f)
        assert bool(got_s.C[-1]) == (steps >= 15)
        with jax.disable_jit():
            want = JLDMX.sample_dpm_solver(eps_fn(jnp), jnp.asarray(x), want_s)
        msgs = []
        got = LDMX.sample_dpm_solver(eps_fn(torch), torch.from_numpy(x), got_s,
                                     progress_cb=msgs.append)
        close(got, want)
        assert msgs == list(range(steps))
    with pytest.raises(ValueError, match="steps >= 2"):
        LDMX.make_dpm_solver_schedule(ACP, 1)


@pytest.fixture(scope="module")
def jax_pipe(bundles):  # noqa: F811
    from cremage_tpu.pipelines.sd15 import SD15Pipeline as JPipeline

    return JPipeline(bundles[0])


def test_sd15_generate_matches_jax(bundles, jax_pipe):  # noqa: F811
    """The whole SD1.5 job with PLMS (from unit noise), the port handed
    JAX's noise; the extra samplers are the JAX server's and t-driven as
    in JAX. DPM Solver's and LCM's jobs are the next test's: each JAX
    sampler program compiles anew, and one test for the three took over
    20 s."""
    from cremage_tpu.pipelines.sd15 import T_DRIVEN_SAMPLERS as J_T_DRIVEN

    assert EXTRA_SAMPLERS == ("PLMS", "DPM Solver", "LCM")
    assert T_DRIVEN_SAMPLERS == J_T_DRIVEN
    _check_generate(bundles[1], jax_pipe, "PLMS", 3)


def test_sd15_generate_with_dpm_solver_and_lcm_matches_jax(
        bundles, jax_pipe):  # noqa: F811
    """The whole SD1.5 job with DPM Solver (from unit noise) and with LCM
    (from its grid's top sigma), as test_sd15_generate_matches_jax."""
    for sampler, steps in (("DPM Solver", 3), ("LCM", 2)):
        _check_generate(bundles[1], jax_pipe, sampler, steps)


def _check_generate(tb, jax_pipe, sampler, steps):
    opts = dict(OPTS, sampler=sampler, sampling_steps=steps)
    j_msgs, t_msgs = [], []
    want = jax_pipe.generate(JOptions(**opts), status_cb=j_msgs.append)
    init, step_noise = jax_noise(42, 0, (2, 8, 8, 4), steps)
    got = SD15Pipeline(tb, device="cpu").generate(
        GenerationOptions(**opts), status_cb=t_msgs.append,
        noise=lambda seed, device: ArrayNoise(init, step_noise, device))
    assert len(got) == len(want) == 2
    for (gi, gm), (wi, wm) in zip(got, want):
        assert_img01_close(gi, wi, float_tol=2.0 / 255.0)
        assert gm == wm
    # JAX's step statuses reach the host asynchronously (io_callback), so
    # the lists agree as multisets; the port's come in order
    assert sorted(t_msgs) == sorted(j_msgs)
    assert t_msgs[-1] == "decoding" and t_msgs[1] == f"1 / {steps}"
    if sampler == "DPM Solver":     # txt2img only, as in JAX
        with pytest.raises(ValueError, match="txt2img only"):
            SD15Pipeline(tb, device="cpu").generate(
                GenerationOptions(**dict(opts, mode="image_to_image")),
                init_image=np.zeros((64, 64, 3), np.float32),
                noise=lambda seed, device: ArrayNoise(init, step_noise, device,
                                                      encode=init,
                                                      posterior=init[:1]))
