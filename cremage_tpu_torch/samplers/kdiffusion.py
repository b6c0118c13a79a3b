"""k-diffusion Euler ancestral sampler (the port's copy of the "Euler A"
entry of cremage_tpu/samplers/kdiffusion.py).

Semantics follow crowsonkb k-diffusion: every schedule-dependent quantity
(ancestral sigma_up / sigma_down) is computed on the host in float64 and
rounded to float32 per step, as the JAX scan feeds them; the sampler
state is float32. The step noise comes from an injectable source
(core/rng.py `NoiseSource`), since torch cannot draw JAX's threefry
numbers.

Signature: sample_euler_ancestral(denoise, x, sigmas, noise) -> x0 where
`denoise(x, sigma) -> denoised` (CFG already applied), `x` is the initial
noise scaled by sigmas[0], and `sigmas` a host array ending in 0.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from cremage_tpu_torch.core.rng import NoiseSource


def _check_sigmas(sigmas) -> np.ndarray:
    s = np.asarray(sigmas, dtype=np.float64)
    if s.ndim != 1 or s.shape[0] < 2:
        raise ValueError("sigmas must be a 1-D array of length >= 2")
    return s


def _ancestral_step_np(sigma_from: float, sigma_to: float):
    """sigma_down/sigma_up for an ancestral step with eta = 1 (host math)."""
    sigma_up = min(
        sigma_to,
        (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5,
    )
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return sigma_down, sigma_up


def sample_euler_ancestral(
    denoise: Callable[[torch.Tensor, float], torch.Tensor],
    x: torch.Tensor,
    sigmas,
    noise: NoiseSource,
    *,
    progress_cb: Optional[Callable[[int], None]] = None,
) -> torch.Tensor:
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    downs, ups = zip(*[_ancestral_step_np(sig[i], sig[i + 1])
                       for i in range(n)])
    # per-step float32 scalars, with the same fp32 arithmetic as the scan
    s_i = np.asarray(sig[:-1], np.float32)
    step = np.asarray(downs, np.float32) - s_i
    up = np.asarray(ups, np.float32)
    x = x.float()
    for i in range(n):
        den = denoise(x, float(s_i[i])).float()
        d = (x - den) / float(s_i[i])
        x = x + d * float(step[i])
        x = x + noise.step(i, tuple(x.shape)) * float(up[i])
        if progress_cb is not None:
            progress_cb(i)
    return x
