"""Latent Consistency Model (LCM) sampling, the scheduler side of LCM-LoRA
(the port of cremage_tpu/samplers/lcm.py; diffusers `LCMScheduler`
semantics).

- timesteps: from the `original_steps` = 50 distillation grid on the
  1000-step training table, origin = arange(1, 51) * 20 - 1, reversed,
  every len(origin) // steps-th entry, the first `steps`; img2img
  (strength < 1) keeps the lowest int(50 * strength) of the grid first;
- per step at timestep t: x0 from the eps denoiser, then the consistency
  boundary scalings (timestep_scaling 10, sigma_data 0.5): s = 10 t,
  c_skip = 0.25 / (s^2 + 0.25), c_out = s / sqrt(s^2 + 0.25),
  denoised = c_out * x0 + c_skip * x_t;
- between steps, the k-space re-noise x = denoised + sigma_next * N(0, 1);
  the last step (sigma_next = 0) returns `denoised`.

The schedule is float64 on the host, rounded to float32 per step as the
JAX scan feeds it; the sampler state x is k-space (x0 + sigma * eps), and
x * c_in with c_in = 1 / sqrt(1 + sigma^2) = sqrt(acp) is the DDPM-space
sample. Step i's noise is `noise.step(i, shape)` (JAX:
split(key, n)[i]); the last step draws none (JAX draws and multiplies by
0).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cremage_tpu_torch.core.rng import NoiseSource
from cremage_tpu_torch.samplers.kdiffusion import Denoise, Progress, _report


@dataclasses.dataclass(frozen=True)
class LCMSchedule:
    sigmas: np.ndarray       # (n,) k-space sigma per step (float64)
    sigma_next: np.ndarray   # (n,) next step's sigma, 0 for the last
    c_skip: np.ndarray       # (n,) boundary-condition skip scale
    c_out: np.ndarray        # (n,) boundary-condition output scale
    c_in: np.ndarray         # (n,) x_k -> x_t (DDPM space) scale
    timesteps: np.ndarray    # (n,) the discrete training timesteps


def make_lcm_schedule(alphas_cumprod, steps: int, original_steps: int = 50,
                      strength: float = 1.0, timestep_scaling: float = 10.0,
                      sigma_data: float = 0.5) -> LCMSchedule:
    """The LCM schedule from the model's alphas_cumprod table."""
    acp = np.asarray(alphas_cumprod, np.float64)
    if not 1 <= steps <= original_steps:
        raise ValueError(
            f"LCM steps must be in [1, {original_steps}], got {steps}")
    k = len(acp) // original_steps
    origin = np.arange(1, original_steps + 1, dtype=np.int64) * k - 1
    if strength < 1.0:
        origin = origin[: max(1, int(original_steps * strength))]
    skip = max(1, len(origin) // steps)
    ts = origin[::-1][::skip][:steps]

    acp_t = acp[ts]
    sigmas = np.sqrt((1.0 - acp_t) / acp_t)
    scaled = ts.astype(np.float64) * timestep_scaling
    return LCMSchedule(
        sigmas=sigmas, sigma_next=np.append(sigmas[1:], 0.0),
        c_skip=sigma_data**2 / (scaled**2 + sigma_data**2),
        c_out=scaled / np.sqrt(scaled**2 + sigma_data**2),
        c_in=1.0 / np.sqrt(1.0 + sigmas**2), timesteps=ts)


def sample_lcm(denoise: Denoise, x: torch.Tensor, sched: LCMSchedule,
               noise: NoiseSource, *, progress_cb: Progress = None
               ) -> torch.Tensor:
    """x: the initial k-space noise (N(0, 1) * sched.sigmas[0]);
    denoise(x_k, sigma) -> x0 (CFG applied). -> the last consistency
    output."""
    f32 = lambda a: np.asarray(a, np.float32)
    sig, s_next = f32(sched.sigmas), f32(sched.sigma_next)
    c_skip, c_out, c_in = f32(sched.c_skip), f32(sched.c_out), f32(sched.c_in)
    x = x.float()
    for i in range(len(sig)):
        x0 = denoise(x, float(sig[i])).float()
        x = float(c_out[i]) * x0 + float(c_skip[i]) * (x * float(c_in[i]))
        if s_next[i]:
            x = x + float(s_next[i]) * noise.step(i, tuple(x.shape))
        _report(progress_cb, i)
    return x
