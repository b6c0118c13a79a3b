"""Rectified-flow sampling for FLUX and SD3 (the port of
cremage_tpu/samplers/flow.py).

x_sigma = (1 - sigma) x0 + sigma noise; the model predicts the velocity
v = noise - x0, and Euler steps x += (sigma_next - sigma) v. The sigmas
are float64 on the host; each step's sigma and step size are rounded to
float32, as the JAX scan feeds them, and x stays float32.

Schedules: FLUX-schnell unshifted; FLUX-dev the resolution-dependent "mu"
time shift (sigma' = e^mu / (e^mu + 1/sigma - 1)); a plain shift
(sigma' = shift sigma / (1 + (shift - 1) sigma)) as SD3 takes it.
`cfg_velocity` is classifier-free guidance for velocity models (FLUX's
guidance is distilled into its embedding; SD3 takes it).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch


def shift_sigmas(sigmas: np.ndarray, shift: float) -> np.ndarray:
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def time_shift_mu(sigmas: np.ndarray, mu: float) -> np.ndarray:
    return math.exp(mu) / (math.exp(mu) + (1 / np.maximum(sigmas, 1e-9) - 1))


def flux_mu(image_seq_len: int, base_len: int = 256, max_len: int = 4096,
            base_shift: float = 0.5, max_shift: float = 1.15) -> float:
    m = (max_shift - base_shift) / (max_len - base_len)
    b = base_shift - m * base_len
    return image_seq_len * m + b


def flow_sigmas(steps: int, shift: float = 1.0,
                mu: Optional[float] = None) -> np.ndarray:
    """Descending sigmas in (0, 1], a trailing 0 appended (float64)."""
    sigmas = np.linspace(1.0, 1.0 / steps, steps, dtype=np.float64)
    if mu is not None:
        sigmas = time_shift_mu(sigmas, mu)
    elif shift != 1.0:
        sigmas = shift_sigmas(sigmas, shift)
    return np.concatenate([sigmas, [0.0]])


def sd3_sigmas(steps: int, shift: float = 3.0) -> np.ndarray:
    return flow_sigmas(steps, shift=shift)


def sample_flow_euler(v_fn: Callable, x: torch.Tensor, sigmas,
                      progress: Optional[Callable[[int], None]] = None
                      ) -> torch.Tensor:
    """Euler over `sigmas`; v_fn(x, sigma) -> velocity, with sigma a
    float32 scalar tensor on x's device. -> x at the last sigma, float32.
    `progress(i)` follows step i."""
    sig = np.asarray(sigmas, np.float64)
    s32 = sig[:-1].astype(np.float32)
    dt32 = np.diff(sig).astype(np.float32)
    x = x.float()
    for i in range(len(sig) - 1):
        s = torch.tensor(s32[i], device=x.device)
        x = x + torch.tensor(dt32[i], device=x.device) * v_fn(x, s).float()
        if progress is not None:
            progress(i)
    return x


def _cat(uc, c):
    if isinstance(uc, dict):
        return {k: _cat(uc[k], c[k]) for k in c}
    return torch.cat([uc, c], dim=0)


def cfg_velocity(v_fn: Callable, c, uc, scale: float,
                 interval: Optional[Tuple[float, float]] = None) -> Callable:
    """CFG for velocity models, batched [uc; c] like the eps samplers
    (cremage_tpu/samplers/flow.py `cfg_velocity`): v_fn(x, sigma (B,),
    cond) -> velocity, where a dict conditioning concatenates key by key.
    -> fn(x, sigma) = v_u + scale (v_c - v_u). Without uc, or at scale 1,
    the conditional model alone. `interval=(lo, hi)` guides only where lo
    <= sigma <= hi (float32); outside, the conditional model runs alone on
    the single batch."""
    def sigma_b(sigma, n, device):
        return torch.as_tensor(sigma, dtype=torch.float32,
                               device=device).expand(n)

    if uc is None or scale == 1.0:
        def fn_nocfg(x, sigma):
            return v_fn(x, sigma_b(sigma, x.shape[0], x.device), c)
        return fn_nocfg

    cond = _cat(uc, c)

    def fn(x, sigma):
        b = x.shape[0]
        if interval is not None:
            s = torch.as_tensor(sigma, dtype=torch.float32).max()
            if not (interval[0] <= s <= interval[1]):
                return v_fn(x, sigma_b(sigma, b, x.device), c)
        v = v_fn(torch.cat([x, x], dim=0), sigma_b(sigma, 2 * b, x.device),
                 cond)
        vu, vc = v[:b], v[b:]
        return vu + scale * (vc - vu)

    return fn
