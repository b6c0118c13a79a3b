"""PLMS and DPM-Solver, the reference ldm engine's two samplers beyond its
menu (the port of cremage_tpu/samplers/ldm_extra.py).

Both are driven by the timestep t, as DDIM is: `eps_fn(x, t) -> eps` is
the eps model under CFG with t an integer-valued (PLMS) or fractional
(DPM-Solver) float, and sampling starts from unit-variance noise. All
schedule math is float64 on the host, rounded to float32 per step as the
JAX program feeds it. Neither draws noise.

PLMS (CompVis plms.py p_sample_plms, eta = 0): step 0 is pseudo improved
Euler (two model calls); steps 1, 2 and 3+ apply the 2nd, 3rd and 4th
order Adams-Bashforth combination of the raw eps history to the DDIM
update. With `t_start` it denoises from DDIM step t_start down (img2img).

DPM-Solver (dpm_solver/sampler.py's configuration: discrete
NoiseScheduleVP, predict_x0, time-uniform steps, multistep order 2,
lower_order_final for steps < 15): per transition
    x_t = A x - B m0 - C (m0 - m1),  A = sigma_t / sigma_s0,
    B = alpha_t expm1(-h),  C = B / (2 r0),
with m0, m1 the x0-predictions at the two previous times and the model
driven at t_input = (t - 1/N) * 1000.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from cremage_tpu_torch.samplers.ddim import DDIMSchedule
from cremage_tpu_torch.samplers.kdiffusion import Progress, _report

# Adams-Bashforth rows [e_t, old[-1], old[-2], old[-3]] for steps with 1, 2
# and >= 3 earlier eps values (plms.py:224-232)
_AB_ROWS = np.array([
    [3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0],
    [23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0],
    [55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0],
], dtype=np.float64)


def sample_plms(eps_fn: Callable, x: torch.Tensor, sched: DDIMSchedule, *,
                t_start: Optional[int] = None,
                progress_cb: Progress = None) -> torch.Tensor:
    """PLMS from pure noise, or from DDIM step t_start down (`decode` of
    img2img). The schedule's eta must be 0."""
    if sched.eta != 0.0:
        raise ValueError("ddim_eta must be 0 for PLMS")
    timesteps = (sched.timesteps if t_start is None
                 else sched.timesteps[:t_start])
    n = len(timesteps)
    idx = np.arange(n)[::-1]                       # newest first
    f32 = lambda a: np.asarray(a, np.float32)
    t = f32(timesteps[::-1])
    a_t, a_prev = sched.alphas[idx], sched.alphas_prev[idx]
    sqrt_at, sqrt_1m_at = f32(np.sqrt(a_t)), f32(np.sqrt(1.0 - a_t))
    sqrt_aprev, dir_coef = f32(np.sqrt(a_prev)), f32(np.sqrt(1.0 - a_prev))
    rows = f32(_AB_ROWS)

    def update(xi, e, i):
        pred_x0 = (xi - float(sqrt_1m_at[i]) * e) / float(sqrt_at[i])
        return float(sqrt_aprev[i]) * pred_x0 + float(dir_coef[i]) * e

    x = x.float()
    e_t = eps_fn(x, float(t[0])).float()
    e_next = eps_fn(update(x, e_t, 0), float(t[min(1, n - 1)])).float()
    x = update(x, (e_t + e_next) / 2.0, 0)
    _report(progress_cb, 0)
    hist = [e_t]                                   # newest first
    for i in range(1, n):
        e = eps_fn(x, float(t[i])).float()
        row = rows[min(i, 3) - 1]
        e_prime = float(row[0]) * e
        for coef, old in zip(row[1:], hist):       # the nonzero terms
            e_prime = e_prime + float(coef) * old
        x = update(x, e_prime, i)
        hist = [e] + hist[:2]
        _report(progress_cb, i)
    return x


@dataclasses.dataclass(frozen=True)
class DPMSolverSchedule:
    """Model input times and per-transition update coefficients."""
    t_model: np.ndarray      # (steps + 1,) model input times
    alphas: np.ndarray       # (steps + 1,) alpha_t
    sigmas_vp: np.ndarray    # (steps + 1,) sigma_t
    A: np.ndarray            # (steps,) sigma_t / sigma_s0
    B: np.ndarray            # (steps,) alpha_t * expm1(-h)
    C: np.ndarray            # (steps,) B / (2 r0); 0 on order-1 steps

    @property
    def num_steps(self) -> int:
        return len(self.A)


def make_dpm_solver_schedule(alphas_cumprod: np.ndarray, num_steps: int,
                             lower_order_final: bool = True
                             ) -> DPMSolverSchedule:
    if num_steps < 2:
        raise ValueError("DPM-Solver multistep order 2 needs steps >= 2")
    acp = np.asarray(alphas_cumprod, dtype=np.float64)
    big_n = len(acp)
    # the discrete NoiseScheduleVP: log alpha interpolated on
    # t_array = linspace(0, 1, N + 1)[1:], time-uniform steps
    t_array = np.linspace(0.0, 1.0, big_n + 1)[1:]
    ts = np.linspace(1.0, 1.0 / big_n, num_steps + 1)
    log_alpha = np.interp(ts, t_array, 0.5 * np.log(acp))
    alpha = np.exp(log_alpha)
    sigma = np.sqrt(1.0 - np.exp(2.0 * log_alpha))
    lam = log_alpha - 0.5 * np.log(1.0 - np.exp(2.0 * log_alpha))
    h = lam[1:] - lam[:-1]
    B = alpha[1:] * np.expm1(-h)
    C = np.zeros_like(B)
    # order 2 but on the first transition and, with lower_order_final and
    # fewer than 15 steps, the last; r0 = h_{i-1} / h_i
    C[1:] = B[1:] * (h[1:] / h[:-1]) * 0.5
    if lower_order_final and num_steps < 15:
        C[-1] = 0.0
    return DPMSolverSchedule((ts - 1.0 / big_n) * 1000.0, alpha, sigma,
                             sigma[1:] / sigma[:-1], B, C)


def sample_dpm_solver(eps_fn: Callable, x: torch.Tensor,
                      sched: DPMSolverSchedule, *,
                      progress_cb: Progress = None) -> torch.Tensor:
    """Multistep order-2 data-prediction DPM-Solver from unit noise."""
    n = sched.num_steps
    f32 = lambda a: np.asarray(a, np.float32)
    t_model, alphas, sigmas = (f32(sched.t_model), f32(sched.alphas),
                               f32(sched.sigmas_vp))
    A, B, C = f32(sched.A), f32(sched.B), f32(sched.C)

    def x0_pred(xi, i):
        e = eps_fn(xi, float(t_model[i])).float()
        return (xi - float(sigmas[i]) * e) / float(alphas[i])

    def step(xi, i, m0, m1):
        xi = float(A[i]) * xi - float(B[i]) * m0
        return xi - float(C[i]) * (m0 - m1) if C[i] else xi

    x = x.float()
    m0, m1 = x0_pred(x, 0), None       # m1 unused on the first transition
    for i in range(n - 1):
        x = step(x, i, m0, m1)
        m0, m1 = x0_pred(x, i + 1), m0
        _report(progress_cb, i)
    # the last transition needs no model call
    x = step(x, n - 1, m0, m1)
    _report(progress_cb, n - 1)
    return x
