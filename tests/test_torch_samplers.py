"""The port's samplers (cremage_tpu_torch/samplers) against the JAX
package's, with no UNet: an analytic denoiser run through both checks each
sampler's step arithmetic, its schedule and its use of noise.

The port is handed the noise the JAX sampler draws from its key (step i,
draw j: split(key, n * per_step).reshape(n, per_step)[i, j]). Everything
is float32 on the CPU; the tolerance is 1e-5 of the result's range
(float32 rounding of a few steps' host coefficients and vector ops).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cremage_tpu.core.registry import SAMPLERS as JSAMPLERS
from cremage_tpu.samplers import ddim as JDDIM
from cremage_tpu.samplers import kdiffusion as JK
from cremage_tpu.samplers import schedules as JS
from cremage_tpu_torch.core.rng import ArrayNoise
from cremage_tpu_torch.pipelines.sd15 import SAMPLER_MENU
from cremage_tpu_torch.samplers import ddim as DDIM
from cremage_tpu_torch.samplers import kdiffusion as K
from cremage_tpu_torch.samplers import schedules as S
from tests.test_torch_pipeline import cheap_jax  # noqa: F401

SHAPE = (2, 4, 4, 4)
STEPS = 5


def denoiser(lib):
    """An analytic stand-in for the CFG'd UNet: smooth in x and sigma."""
    return lambda x, s: x * (0.6 / (1.0 + s)) + 0.2 * lib.tanh(x) - 0.05


def jax_steps(key, n, per_step=1, shape=SHAPE):
    """The per-step noise the JAX samplers draw (kdiffusion._keys)."""
    ks = jax.random.split(key, n * per_step).reshape(n, per_step)
    draw = lambda k: np.asarray(jax.random.normal(k, shape, jnp.float32))
    return [draw(ks[i, 0]) if per_step == 1 else
            tuple(draw(ks[i, j]) for j in range(per_step)) for i in range(n)]


def sigmas_for(name, steps=STEPS, t_enc=None):
    sched = S.default_sd_schedule()
    if K.SAMPLER_SCHEDULE[name] == "model":
        sig = sched.get_sigmas(steps)
    else:
        sig = S.get_sigmas_karras(steps, sched.sigma_min, sched.sigma_max)
    return sig if t_enc is None else S.truncate_for_img2img(sig, t_enc)


def test_menu_is_the_references():
    assert SAMPLER_MENU == ("DDIM",) + tuple(sorted(JK.SAMPLER_SCHEDULE))
    assert K.SAMPLER_SCHEDULE == JK.SAMPLER_SCHEDULE
    assert set(K.SAMPLERS) == set(JK.SAMPLER_SCHEDULE)


def test_schedules_match_jax():
    ours, ref = S.default_sd_schedule(), JS.default_sd_schedule()
    assert (ours.sigma_min, ours.sigma_max) == (ref.sigma_min, ref.sigma_max)
    for n in (1, 4, 20):
        np.testing.assert_array_equal(
            S.get_sigmas_karras(n, ours.sigma_min, ours.sigma_max),
            JS.get_sigmas_karras(n, ref.sigma_min, ref.sigma_max))
    sig = ours.get_sigmas(10)
    for t_enc in (1, 7, 10):
        np.testing.assert_array_equal(S.truncate_for_img2img(sig, t_enc),
                                      JS.truncate_for_img2img(sig, t_enc))
    with pytest.raises(ValueError):
        S.truncate_for_img2img(sig, 11)
    acp = 1.0 / (1.0 + ref.sigmas**2)
    np.testing.assert_array_equal(ours.alphas_cumprod, acp)
    for steps in (3, 20, 50):
        a, b = DDIM.make_ddim_schedule(acp, steps, 0.5), \
            JDDIM.make_ddim_schedule(acp, steps, 0.5)
        for f in ("timesteps", "alphas", "alphas_prev", "sigmas"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


# (sampler, t_enc, kwargs): every k-diffusion sampler at the full schedule,
# at an img2img tail of 2 steps and at a tail of 1 (only the last step);
# Euler, Heun and DPM2 also with Karras' churn
KDIFF_CASES = (
    [(n, t, {}) for n in sorted(K.SAMPLERS) for t in (None, 2, 1)]
    + [(n, None, dict(s_churn=2.0, s_tmin=0.1, s_tmax=20.0, s_noise=1.003))
       for n in K.CHURN_SAMPLERS]
    + [("Euler", 3, dict(s_churn=1.0, s_tmin=0.0, s_tmax=999.0, s_noise=1.0))])


@pytest.mark.parametrize("name,t_enc,kw", KDIFF_CASES,
                         ids=[f"{n}-{t}-{'churn' if kw else 'plain'}"
                              for n, t, kw in KDIFF_CASES])
def test_kdiffusion_sampler_matches_jax(name, t_enc, kw):
    sigmas = sigmas_for(name, t_enc=t_enc)
    n = len(sigmas) - 1
    key = jax.random.key(11)
    x0 = (np.random.RandomState(3).randn(*SHAPE) * float(sigmas[0])).astype(
        np.float32)
    fn = JSAMPLERS.get(name)
    with jax.disable_jit():     # op by op: no per-case compile of the scan
        want = fn(denoiser(jnp), jnp.asarray(x0), sigmas, key=key, **kw)
    per_step = 2 if name == "DPM++ SDE" else 1
    seen = []
    got = K.SAMPLERS[name](denoiser(torch), torch.from_numpy(x0), sigmas,
                           ArrayNoise(None, jax_steps(key, n, per_step)),
                           progress_cb=seen.append, **kw)
    want = np.asarray(want)
    assert got.dtype == torch.float32 and got.shape == SHAPE
    assert seen == list(range(n))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * float(np.abs(want).max()), rtol=0)


@pytest.mark.parametrize("eta,t_start", [(0.0, None), (0.7, None), (0.0, 3),
                                         (0.7, 2)])
def test_ddim_matches_jax(eta, t_start):
    """DDIM is t-driven: the eps model gets the integer DDPM timestep."""
    acp = 1.0 / (1.0 + S.default_sd_schedule().sigmas**2)
    steps = 5
    ours, ref = DDIM.make_ddim_schedule(acp, steps, eta), \
        JDDIM.make_ddim_schedule(acp, steps, eta)

    def eps(lib):
        return lambda x, t: 0.3 * x + lib.sin(x * 0.5) * (t / 1000.0)

    key = jax.random.key(5)
    rng = np.random.RandomState(4)
    x0 = rng.randn(*SHAPE).astype(np.float32)
    if t_start is None:
        with jax.disable_jit():
            want = JDDIM.sample(eps(jnp), jnp.asarray(x0), ref, key=key)
        start = torch.from_numpy(x0)
        n = ref.num_steps
    else:
        enc = rng.randn(*SHAPE).astype(np.float32)
        xt = JDDIM.stochastic_encode(jnp.asarray(x0), ref, t_start - 1,
                                     jnp.asarray(enc))
        with jax.disable_jit():
            want = JDDIM.decode(eps(jnp), xt, ref, t_start, key=key)
        start = DDIM.stochastic_encode(torch.from_numpy(x0), ours,
                                       t_start - 1, torch.from_numpy(enc))
        np.testing.assert_allclose(start.numpy(), np.asarray(xt), atol=1e-6,
                                   rtol=1e-6)
        n = t_start
    steps_noise = [np.asarray(jax.random.normal(k, SHAPE, jnp.float32))
                   for k in jax.random.split(key, n)]
    seen = []
    got = DDIM.sample(eps(torch), start, ours, ArrayNoise(None, steps_noise),
                      t_start=t_start, progress_cb=seen.append)
    want = np.asarray(want)
    assert seen == list(range(n))
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * float(np.abs(want).max()), rtol=0)


def test_deterministic_samplers_draw_no_noise():
    """Without churn, Euler, Heun, DPM2, LMS and DPM++ 2M use no step
    noise; the ancestral and SDE samplers draw on every step but the
    last (DPM++ SDE two a step)."""
    class Counting:
        def __init__(self):
            self.draws = []

        def step(self, i, shape, draw=0):
            self.draws.append((i, draw))
            return torch.zeros(shape)

    want = {"Euler": [], "Heun": [], "DPM2": [], "LMS": [], "DPM++ 2M": [],
            "Euler A": [(i, 0) for i in range(STEPS - 1)],
            "DPM2 A": [(i, 0) for i in range(STEPS - 1)],
            "DPM++ 2S A": [(i, 0) for i in range(STEPS - 1)],
            "DPM++ SDE": [(i, j) for i in range(STEPS - 1) for j in (0, 1)],
            "DPM++ 2M SDE": [(i, 0) for i in range(STEPS - 1)],
            "DPM++ 3M SDE": [(i, 0) for i in range(STEPS - 1)]}
    for name, fn in K.SAMPLERS.items():
        src = Counting()
        fn(denoiser(torch), torch.ones(SHAPE), sigmas_for(name), src)
        assert src.draws == want[name], name
