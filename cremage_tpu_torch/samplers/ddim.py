"""DDIM sampler (Song et al. 2020), the port of cremage_tpu/samplers/ddim.py.

Schedule semantics are CompVis': uniform timestep spacing with the +1
offset, eta-scaled sigmas, `stochastic_encode` to a DDIM step for img2img
and `decode` from it. The schedule is float64 on the host and each step's
coefficients are rounded to float32, as the JAX scan feeds them.

DDIM is driven by the timestep t, not sigma: `eps_fn(x, t) -> eps` is the
eps model under CFG (not `EpsDenoiser`), with t an integer-valued float,
and sampling starts from unit-variance noise.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from cremage_tpu_torch.core.rng import NoiseSource


@dataclasses.dataclass(frozen=True)
class DDIMSchedule:
    timesteps: np.ndarray        # ascending ints, len S (DDPM t values)
    alphas: np.ndarray           # acp[timesteps]
    alphas_prev: np.ndarray      # acp[previous timesteps] (acp[0] first)
    sigmas: np.ndarray           # eta-scaled DDIM sigmas
    eta: float

    @property
    def num_steps(self) -> int:
        return len(self.timesteps)


def make_ddim_schedule(alphas_cumprod: np.ndarray, num_steps: int,
                       eta: float = 0.0) -> DDIMSchedule:
    """Uniform DDIM timesteps over the DDPM table (CompVis
    make_ddim_timesteps, +1 offset) and their sampling parameters."""
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    num_ddpm = len(acp)
    ts = np.arange(0, num_ddpm, num_ddpm // num_steps) + 1
    ts = np.clip(ts, 0, num_ddpm - 1)
    alphas = acp[ts]
    alphas_prev = np.concatenate([acp[:1], acp[ts[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas)
                           * (1 - alphas / alphas_prev))
    return DDIMSchedule(ts, alphas, alphas_prev, sigmas, float(eta))


def stochastic_encode(x0: torch.Tensor, sched: DDIMSchedule, t_enc: int,
                      noise: torch.Tensor) -> torch.Tensor:
    """Forward-diffuse x0 to DDIM step t_enc (the DDIM alphas)."""
    a = float(np.float32(np.sqrt(sched.alphas[t_enc])))
    b = float(np.float32(np.sqrt(1.0 - sched.alphas[t_enc])))
    return a * x0.float() + b * noise.float()


def sample(eps_fn: Callable, x: torch.Tensor, sched: DDIMSchedule,
           noise: NoiseSource, *, t_start: Optional[int] = None,
           progress_cb: Optional[Callable[[int], None]] = None) -> torch.Tensor:
    """DDIM from the last of the schedule's steps (full sampling from
    x ~ N(0, I)), or from step t_start down (`decode` of img2img)."""
    if t_start is None:
        t_start = sched.num_steps
    idx = np.arange(t_start)[::-1]                 # newest first
    a_t, a_prev = sched.alphas[idx], sched.alphas_prev[idx]
    sigma_t = sched.sigmas[idx]
    ts = np.asarray(sched.timesteps[idx], np.float32)
    sqrt_at, sqrt_1m_at = np.float32(np.sqrt(a_t)), np.float32(np.sqrt(1 - a_t))
    sqrt_aprev = np.float32(np.sqrt(a_prev))
    dir_coef = np.float32(np.sqrt(np.maximum(1.0 - a_prev - sigma_t**2, 0.0)))
    sigma_t = np.float32(sigma_t)
    x = x.float()
    for i in range(t_start):
        e_t = eps_fn(x, float(ts[i])).float()
        pred_x0 = (x - float(sqrt_1m_at[i]) * e_t) / float(sqrt_at[i])
        x = float(sqrt_aprev[i]) * pred_x0 + float(dir_coef[i]) * e_t
        if sched.eta > 0:
            x = x + float(sigma_t[i]) * noise.step(i, tuple(x.shape))
        if progress_cb is not None:
            progress_cb(i)
    return x
