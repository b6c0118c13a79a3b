"""Sigma schedules for the port (numpy copy of the parts of
cremage_tpu/samplers/schedules.py the SD1.5 txt2img path uses).

All schedule math is float64 on the host (numpy); schedules are tiny
(<= 1001 elements), so there is no reason to compute them on the device.

- DDPM "linear" beta schedule = linspace in sqrt(beta) space, squared
  (CompVis convention).
- k-diffusion discrete schedule: sigma_t = sqrt((1-acp_t)/acp_t),
  `get_sigmas(n)` linspace over t then interp in log-sigma, append 0.
"""
from __future__ import annotations

import numpy as np

# SD1.x / SDXL DDPM schedule constants (configs/ldm v1-inference.yaml).
DDPM_NUM_TIMESTEPS = 1000
LINEAR_START = 0.00085
LINEAR_END = 0.0120


def make_betas_linear(
    n: int = DDPM_NUM_TIMESTEPS,
    linear_start: float = LINEAR_START,
    linear_end: float = LINEAR_END,
) -> np.ndarray:
    """CompVis 'linear' schedule: linspace in sqrt(beta), squared."""
    return (
        np.linspace(linear_start**0.5, linear_end**0.5, n, dtype=np.float64) ** 2
    )


def alphas_cumprod_from_betas(betas: np.ndarray) -> np.ndarray:
    return np.cumprod(1.0 - betas, axis=0)


def make_alphas_cumprod(
    n: int = DDPM_NUM_TIMESTEPS,
    linear_start: float = LINEAR_START,
    linear_end: float = LINEAR_END,
) -> np.ndarray:
    return alphas_cumprod_from_betas(make_betas_linear(n, linear_start, linear_end))


def sigmas_from_alphas_cumprod(alphas_cumprod: np.ndarray) -> np.ndarray:
    """k-diffusion discrete sigmas: sqrt((1-acp)/acp), ascending in t."""
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    return np.sqrt((1.0 - acp) / acp)


def append_zero(x: np.ndarray) -> np.ndarray:
    return np.concatenate([x, np.zeros((1,), dtype=x.dtype)])


class DiscreteSchedule:
    """Discrete DDPM sigma table with t -> sigma interpolation in log-sigma
    (semantics of k_diffusion/external.py DiscreteSchedule)."""

    def __init__(self, sigmas: np.ndarray):
        self.sigmas = np.asarray(sigmas, dtype=np.float64)  # ascending, len T
        self.log_sigmas = np.log(self.sigmas)

    def t_to_sigma(self, t: np.ndarray) -> np.ndarray:
        t = np.asarray(t, dtype=np.float64)
        low_idx = np.floor(t).astype(np.int64)
        high_idx = np.ceil(t).astype(np.int64)
        w = t - low_idx
        log_sigma = (1 - w) * self.log_sigmas[low_idx] + w * self.log_sigmas[high_idx]
        return np.exp(log_sigma)

    def get_sigmas(self, n: int) -> np.ndarray:
        """n sampling sigmas descending, with trailing 0."""
        t_max = len(self.sigmas) - 1
        t = np.linspace(t_max, 0, n, dtype=np.float64)
        return append_zero(self.t_to_sigma(t))


def default_sd_schedule() -> DiscreteSchedule:
    """The SD1.x/SDXL-base discrete schedule (1000-step linear DDPM)."""
    return DiscreteSchedule(sigmas_from_alphas_cumprod(make_alphas_cumprod()))
