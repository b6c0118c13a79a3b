"""Sigma schedules for the port (numpy copy of the parts of
cremage_tpu/samplers/schedules.py the SD1.5 pipeline uses).

All schedule math is float64 on the host (numpy); schedules are tiny
(<= 1001 elements), so there is no reason to compute them on the device.

- DDPM "linear" beta schedule = linspace in sqrt(beta) space, squared
  (CompVis convention); PixArt's true-linear one (linspace in beta);
  Kandinsky's squaredcos_cap_v2 (diffusers) one.
- k-diffusion discrete schedule: sigma_t = sqrt((1-acp_t)/acp_t),
  `get_sigmas(n)` linspace over t then interp in log-sigma, append 0.
- Karras (rho = 7) sigmas over the model's [sigma_min, sigma_max] for the
  DPM family of the sampler menu; img2img keeps the schedule's tail.
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


def make_betas_plain_linear(
    n: int = DDPM_NUM_TIMESTEPS,
    beta_start: float = 0.0001,
    beta_end: float = 0.02,
) -> np.ndarray:
    """True-linear beta schedule (diffusers 'linear'; PixArt)."""
    return np.linspace(beta_start, beta_end, n, dtype=np.float64)


def make_betas_squaredcos(n: int = DDPM_NUM_TIMESTEPS,
                          max_beta: float = 0.999) -> np.ndarray:
    """squaredcos_cap_v2 (diffusers; Kandinsky's prior and decoder):
    beta_t = min(1 - abar((t + 1) / n) / abar(t / n), max_beta) with
    abar(s) = cos((s + 0.008) / 1.008 * pi / 2)^2."""
    def abar(t):
        return np.cos((t + 0.008) / 1.008 * np.pi / 2) ** 2

    t1 = np.arange(n, dtype=np.float64) / n
    t2 = (np.arange(n, dtype=np.float64) + 1) / n
    return np.minimum(1 - abar(t2) / abar(t1), max_beta)


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

    @property
    def sigma_min(self) -> float:
        return float(self.sigmas[0])

    @property
    def sigma_max(self) -> float:
        return float(self.sigmas[-1])

    @property
    def alphas_cumprod(self) -> np.ndarray:
        """The DDPM table back from the sigmas: acp = 1 / (1 + sigma^2)."""
        return 1.0 / (1.0 + self.sigmas**2)

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


def get_sigmas_karras(n: int, sigma_min: float, sigma_max: float,
                      rho: float = 7.0) -> np.ndarray:
    """Karras et al. (2022) noise levels, descending, with trailing 0."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return append_zero((max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho)


def truncate_for_img2img(sigmas: np.ndarray, t_enc: int) -> np.ndarray:
    """The last t_enc + 1 sigmas: partial denoising from step n - t_enc."""
    if not 1 <= t_enc < len(sigmas):
        raise ValueError(f"t_enc {t_enc} outside [1, {len(sigmas) - 1}]")
    return sigmas[-(t_enc + 1):]


def default_sd_schedule() -> DiscreteSchedule:
    """The SD1.x/SDXL-base discrete schedule (1000-step linear DDPM)."""
    return DiscreteSchedule(sigmas_from_alphas_cumprod(make_alphas_cumprod()))
