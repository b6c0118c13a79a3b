"""Denoiser wrappers: eps and v parameterizations + CFG (the port's copy of
the parts of cremage_tpu/samplers/denoiser.py its pipelines use).

A *denoiser* is a function `denoise(x, sigma) -> denoised` (the
k-diffusion convention; sigma is a scalar or per-batch vector), with
c_in = 1/sqrt(sigma^2 + sigma_data^2) and t the fractional timestep
interpolated in log-sigma:
- eps: denoised = x - sigma * eps(x * c_in, t);
- v (Hunyuan-DiT): denoised = c_skip * x + c_out * v(x * c_in, t), c_skip =
  sigma_data^2 / (sigma^2 + sigma_data^2), c_out = -sigma * sigma_data /
  sqrt(sigma^2 + sigma_data^2).

CFG runs as one batched model call over [uncond; cond] and combines
e_uc + scale * (e_c - e_uc), uncond first (reference ordering); a
conditioning that is a tuple of tensors is batched element by element.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from cremage_tpu_torch.samplers.schedules import DiscreteSchedule


def _append_dims(x: torch.Tensor, ndim: int) -> torch.Tensor:
    return x.reshape(x.shape + (1,) * (ndim - x.ndim))


def _bcast_sigma(sigma, batch: int, device) -> torch.Tensor:
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    if sigma.ndim == 0:
        sigma = sigma.expand(batch)
    return sigma


def sigma_to_t(schedule: DiscreteSchedule, sigma: torch.Tensor) -> torch.Tensor:
    """Fractional timestep by interpolation in log-sigma space, in fp32
    on sigma's device (cremage_tpu/samplers/denoiser.py `sigma_to_t_jax`)."""
    log_sigmas = torch.as_tensor(schedule.log_sigmas, dtype=torch.float32,
                                 device=sigma.device)
    log_sigma = torch.log(sigma)
    dists = log_sigma[None, :] - log_sigmas[:, None]
    low_idx = torch.clamp(
        torch.argmax(torch.cumsum((dists >= 0).to(torch.int32), dim=0), dim=0),
        0, log_sigmas.shape[0] - 2)
    high_idx = low_idx + 1
    low, high = log_sigmas[low_idx], log_sigmas[high_idx]
    w = torch.clamp((low - log_sigma) / (low - high), 0, 1)
    return (1 - w) * low_idx + w * high_idx


class EpsDenoiser:
    """Wrap an eps-prediction model into denoise(x, sigma, cond)."""

    def __init__(self, eps_model: Callable[..., torch.Tensor],
                 schedule: DiscreteSchedule, sigma_data: float = 1.0):
        self.eps_model = eps_model
        self.schedule = schedule
        self.sigma_data = sigma_data

    def __call__(self, x, sigma, cond: Any = None):
        sigma = _bcast_sigma(sigma, x.shape[0], x.device)
        c_in = 1.0 / torch.sqrt(sigma**2 + self.sigma_data**2)
        t = sigma_to_t(self.schedule, sigma)
        eps = self.eps_model(x * _append_dims(c_in, x.ndim), t, cond)
        return x - eps.float() * _append_dims(sigma, x.ndim)


class VDenoiser:
    """Wrap a v-prediction model into denoise(x, sigma, cond)."""

    def __init__(self, v_model: Callable[..., torch.Tensor],
                 schedule: DiscreteSchedule, sigma_data: float = 1.0):
        self.v_model = v_model
        self.schedule = schedule
        self.sigma_data = sigma_data

    def __call__(self, x, sigma, cond: Any = None):
        sigma = _bcast_sigma(sigma, x.shape[0], x.device)
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = -sigma * self.sigma_data / torch.sqrt(sigma ** 2 + sd2)
        c_in = 1.0 / torch.sqrt(sigma ** 2 + sd2)
        t = sigma_to_t(self.schedule, sigma)
        v = self.v_model(x * _append_dims(c_in, x.ndim), t, cond).float()
        return _append_dims(c_skip, x.ndim) * x + _append_dims(c_out, x.ndim) * v


def cfg_denoiser(denoise: Callable, cond: Any, uncond: Any,
                 scale: float) -> Callable:
    """Close a conditional denoiser over (cond, uncond, scale); returns
    `denoise(x, sigma) -> denoised`. cond and uncond are tensors or tuples
    of tensors."""
    if uncond is None or scale == 1.0:
        return lambda x, sigma: denoise(x, sigma, cond)
    cond_in = (tuple(torch.cat([u, c], dim=0) for u, c in zip(uncond, cond))
               if isinstance(cond, tuple) else torch.cat([uncond, cond], dim=0))

    def fn(x, sigma):
        b = x.shape[0]
        sigma = _bcast_sigma(sigma, b, x.device)
        d = denoise(torch.cat([x, x], dim=0), torch.cat([sigma, sigma], dim=0),
                    cond_in)
        d_u, d_c = d[:b], d[b:]
        return d_u + scale * (d_c - d_u)

    return fn
