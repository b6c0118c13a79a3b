"""The k-diffusion samplers of the reference's menu (the port of
cremage_tpu/samplers/kdiffusion.py).

Semantics follow crowsonkb k-diffusion as the JAX package runs it: every
schedule-dependent quantity (sigma_hat and the churn, ancestral
sigma_up / sigma_down, log-space midpoints, expm1 coefficients, the LMS
integrals) is computed on the host in float64 and rounded to float32 per
step, as the JAX scans feed them; the sampler state is float32. The steps
the JAX package peels out of its scans (a first step without history, a
last step that is plain Euler to sigma = 0) are peeled here too, with the
same host scalars. Noise comes from an injectable source (core/rng.py
`NoiseSource`): step i's draw stands for the JAX key
split(key, n * per_step).reshape(n, per_step)[i, draw]. A step whose noise
scale is 0 draws nothing (JAX draws and multiplies by 0).

Every sampler has the signature
    sample_x(denoise, x, sigmas, noise, *, progress_cb=None, ...) -> x0
where `denoise(x, sigma) -> denoised` (CFG already applied), `x` is the
initial noise scaled by the caller (x = N(0, 1) * sigmas[0] in
k-diffusion's convention), `sigmas` a host array ending in 0, and
`progress_cb(i)` is called once after each step i.

`SAMPLERS` maps the menu's names to the functions and `SAMPLER_SCHEDULE`
to their sigma schedule: "model" (the discrete model schedule) or
"karras" (Karras, rho = 7, over the model's sigma range).
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from scipy import integrate

from cremage_tpu_torch.core.rng import NoiseSource

Denoise = Callable[[torch.Tensor, float], torch.Tensor]
Progress = Optional[Callable[[int], None]]


def _check_sigmas(sigmas) -> np.ndarray:
    s = np.asarray(sigmas, dtype=np.float64)
    if s.ndim != 1 or s.shape[0] < 2:
        raise ValueError("sigmas must be a 1-D array of length >= 2")
    return s


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def _report(progress_cb: Progress, i: int) -> None:
    if progress_cb is not None:
        progress_cb(i)


def _den(denoise: Denoise, x: torch.Tensor, sigma) -> torch.Tensor:
    return denoise(x, float(sigma)).float()


def _to_d(x, sigma, denoised):
    return (x - denoised) / float(sigma)


def _ancestral_step_np(sigma_from: float, sigma_to: float, eta: float = 1.0):
    """sigma_down/sigma_up for an ancestral step (host math)."""
    if not eta:
        return sigma_to, 0.0
    sigma_up = min(
        sigma_to,
        eta * (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5,
    )
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return sigma_down, sigma_up


def _churn(sig: np.ndarray, s_churn: float, s_tmin: float, s_tmax: float):
    """Karras churn: (sigma_hat, scale of the noise added to reach it)."""
    n = len(sig) - 1
    gamma = np.where(
        (s_tmin <= sig[:-1]) & (sig[:-1] <= s_tmax),
        min(s_churn / n, 2**0.5 - 1) if s_churn else 0.0,
        0.0,
    )
    sigma_hat = sig[:-1] * (gamma + 1)
    return sigma_hat, np.sqrt(np.maximum(sigma_hat**2 - sig[:-1] ** 2, 0.0))


def _add_noise(x, noise: NoiseSource, i: int, scale, draw: int = 0):
    """x + N(0, 1) * scale (scale already includes s_noise); no draw at 0."""
    if scale == 0:
        return x
    return x + noise.step(i, tuple(x.shape), draw) * float(scale)


def _euler_to_zero(denoise, x, s_last, progress_cb, i):
    """The peeled last step: sigma_next == 0, plain Euler."""
    s = np.float32(s_last)
    d = _to_d(x, s, _den(denoise, x, s))
    _report(progress_cb, i)
    return x + d * float(-s)


def sample_euler(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                 s_churn: float = 0.0, s_tmin: float = 0.0,
                 s_tmax: float = float("inf"), s_noise: float = 1.0,
                 progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    sigma_hat, churn = _churn(sig, s_churn, s_tmin, s_tmax)
    s_hat, dt, churn = _f32(sigma_hat), _f32(sig[1:] - sigma_hat), _f32(churn)
    x = x.float()
    for i in range(len(sig) - 1):
        if churn[i]:
            x = x + noise.step(i, tuple(x.shape)) * s_noise * float(churn[i])
        d = _to_d(x, s_hat[i], _den(denoise, x, s_hat[i]))
        x = x + d * float(dt[i])
        _report(progress_cb, i)
    return x


def sample_euler_ancestral(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                           progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    downs, ups = zip(*[_ancestral_step_np(sig[i], sig[i + 1])
                       for i in range(n)])
    s_i = _f32(sig[:-1])
    step = _f32(downs) - s_i            # the scan's fp32 (s_down - s_i)
    up = _f32(ups)
    x = x.float()
    for i in range(n):
        d = _to_d(x, s_i[i], _den(denoise, x, s_i[i]))
        x = x + d * float(step[i])
        x = _add_noise(x, noise, i, up[i])
        _report(progress_cb, i)
    return x


def sample_heun(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                s_churn: float = 0.0, s_tmin: float = 0.0,
                s_tmax: float = float("inf"), s_noise: float = 1.0,
                progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    sigma_hat, churn = _churn(sig, s_churn, s_tmin, s_tmax)
    s_hat, s_next, churn32 = _f32(sigma_hat), _f32(sig[1:]), _f32(churn)
    x = x.float()
    for i in range(n - 1):
        if churn32[i]:
            x = x + noise.step(i, tuple(x.shape)) * s_noise * float(churn32[i])
        d = _to_d(x, s_hat[i], _den(denoise, x, s_hat[i]))
        dt = float(s_next[i] - s_hat[i])
        x2 = x + d * dt
        d2 = _to_d(x2, s_next[i], _den(denoise, x2, s_next[i]))
        x = x + (d + d2) / 2 * dt
        _report(progress_cb, i)
    if churn[-1]:
        x = x + noise.step(n - 1, tuple(x.shape)) * s_noise * float(churn[-1])
    return _euler_to_zero(denoise, x, sigma_hat[-1], progress_cb, n - 1)


def sample_dpm_2(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                 s_churn: float = 0.0, s_tmin: float = 0.0,
                 s_tmax: float = float("inf"), s_noise: float = 1.0,
                 progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    sigma_hat, churn = _churn(sig, s_churn, s_tmin, s_tmax)
    x = x.float()
    if n > 1:
        with np.errstate(divide="ignore"):
            sigma_mid = np.exp(np.log(sigma_hat[:-1]) + (
                np.log(sig[1:-1]) - np.log(sigma_hat[:-1])) * 0.5)
        s_hat, s_mid, churn32 = _f32(sigma_hat), _f32(sigma_mid), _f32(churn)
        dt_1 = _f32(sigma_mid - sigma_hat[:-1])
        dt_2 = _f32(sig[1:-1] - sigma_hat[:-1])
        for i in range(n - 1):
            if churn32[i]:
                x = x + noise.step(i, tuple(x.shape)) * s_noise * \
                    float(churn32[i])
            d = _to_d(x, s_hat[i], _den(denoise, x, s_hat[i]))
            x2 = x + d * float(dt_1[i])
            d_2 = _to_d(x2, s_mid[i], _den(denoise, x2, s_mid[i]))
            x = x + d_2 * float(dt_2[i])
            _report(progress_cb, i)
    if churn[-1]:
        x = x + noise.step(n - 1, tuple(x.shape)) * s_noise * float(churn[-1])
    return _euler_to_zero(denoise, x, sigma_hat[-1], progress_cb, n - 1)


def sample_dpm_2_ancestral(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                           progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    downs, ups = map(np.array, zip(*[_ancestral_step_np(sig[i], sig[i + 1])
                                     for i in range(n)]))
    x = x.float()
    if n > 1:
        sigma_mid = np.exp(np.log(sig[:-2])
                           + (np.log(downs[:-1]) - np.log(sig[:-2])) * 0.5)
        s_i, s_mid, up = _f32(sig[:-2]), _f32(sigma_mid), _f32(ups)
        dt_1, dt_2 = _f32(sigma_mid - sig[:-2]), _f32(downs[:-1] - sig[:-2])
        for i in range(n - 1):
            d = _to_d(x, s_i[i], _den(denoise, x, s_i[i]))
            x2 = x + d * float(dt_1[i])
            d_2 = _to_d(x2, s_mid[i], _den(denoise, x2, s_mid[i]))
            x = x + d_2 * float(dt_2[i])
            x = _add_noise(x, noise, i, up[i])
            _report(progress_cb, i)
    return _euler_to_zero(denoise, x, sig[-2], progress_cb, n - 1)


def _lms_coeff(order: int, t: np.ndarray, i: int, j: int) -> float:
    def fn(tau):
        prod = 1.0
        for k in range(order):
            if j == k:
                continue
            prod *= (tau - t[i - k]) / (t[i - j] - t[i - k])
        return prod

    return integrate.quad(fn, t[i], t[i + 1], epsrel=1e-4)[0]


def sample_lms(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
               order: int = 4, progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    coeffs = np.zeros((n, order), dtype=np.float64)
    for i in range(n):
        for j in range(min(i + 1, order)):
            coeffs[i, j] = _lms_coeff(min(i + 1, order), sig, i, j)
    coeffs, s_i = _f32(coeffs), _f32(sig[:-1])
    x = x.float()
    ds = torch.zeros((order,) + tuple(x.shape), dtype=torch.float32,
                     device=x.device)
    for i in range(n):
        d = _to_d(x, s_i[i], _den(denoise, x, s_i[i]))
        ds = torch.cat([d[None], ds[:-1]], dim=0)      # newest first
        x = x + torch.tensordot(torch.from_numpy(coeffs[i]).to(x.device), ds,
                                dims=([0], [0]))
        _report(progress_cb, i)
    return x


def sample_dpmpp_2s_ancestral(denoise: Denoise, x, sigmas,
                              noise: NoiseSource, *,
                              progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    downs, ups = map(np.array, zip(*[_ancestral_step_np(sig[i], sig[i + 1])
                                     for i in range(n)]))
    x = x.float()
    if n > 1:
        t = -np.log(sig[:-2])                   # t = -log sigma
        h = -np.log(downs[:-1]) - t
        sigma_s = np.exp(-(t + 0.5 * h))
        s_i, s_mid, up = _f32(sig[:-2]), _f32(sigma_s), _f32(ups)
        a1, e1 = _f32(sigma_s / sig[:-2]), _f32(np.expm1(-h * 0.5))
        a2, e2 = _f32(downs[:-1] / sig[:-2]), _f32(np.expm1(-h))
        for i in range(n - 1):
            den = _den(denoise, x, s_i[i])
            x2 = float(a1[i]) * x - float(e1[i]) * den
            den2 = _den(denoise, x2, s_mid[i])
            x = float(a2[i]) * x - float(e2[i]) * den2
            x = _add_noise(x, noise, i, up[i])
            _report(progress_cb, i)
    return _euler_to_zero(denoise, x, sig[-2], progress_cb, n - 1)


def sample_dpmpp_sde(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                     s_noise: float = 1.0, r: float = 0.5,
                     progress_cb: Progress = None):
    """Two draws a step, the second leg's noise correlated with the first
    as k-diffusion's Brownian tree correlates them (weights w1, w2)."""
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    x = x.float()
    if n > 1:
        t = -np.log(sig[:-2])
        h = -np.log(sig[1:-1]) - t
        sigma_s = np.exp(-(t + h * r))
        fac = np.float32(1.0 / (2.0 * r))
        sd1, su1 = map(np.array, zip(*[_ancestral_step_np(sig[i], sigma_s[i])
                                       for i in range(n - 1)]))
        sd2, su2 = map(np.array, zip(*[_ancestral_step_np(sig[i], sig[i + 1])
                                       for i in range(n - 1)]))
        a1, e1 = _f32(sd1 / sig[:-2]), _f32(np.expm1(t + np.log(sd1)))
        a2, e2 = _f32(sd2 / sig[:-2]), _f32(np.expm1(t + np.log(sd2)))
        d1, d2 = np.abs(sig[:-2] - sigma_s), np.abs(sigma_s - sig[1:-1])
        w1, w2 = _f32(np.sqrt(d1 / (d1 + d2))), _f32(np.sqrt(d2 / (d1 + d2)))
        s_i, s_mid, su1, su2 = _f32(sig[:-2]), _f32(sigma_s), _f32(su1), _f32(su2)
        for i in range(n - 1):
            shape = tuple(x.shape)
            den = _den(denoise, x, s_i[i])
            z1, z2 = noise.step(i, shape, 0), noise.step(i, shape, 1)
            x2 = float(a1[i]) * x - float(e1[i]) * den
            x2 = x2 + z1 * s_noise * float(su1[i])
            den2 = _den(denoise, x2, s_mid[i])
            den_d = float(1 - fac) * den + float(fac) * den2
            x = float(a2[i]) * x - float(e2[i]) * den_d
            x = x + (float(w1[i]) * z1 + float(w2[i]) * z2) * s_noise * \
                float(su2[i])
            _report(progress_cb, i)
    return _euler_to_zero(denoise, x, sig[-2], progress_cb, n - 1)


def sample_dpmpp_2m(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                    progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    with np.errstate(divide="ignore"):
        t = -np.log(sig)                          # t[n] = +inf at sigma = 0
    h = t[1:] - t[:-1]
    a, e = sig[1:] / sig[:-1], np.expm1(-h)       # a[-1] = 0, e[-1] = -1
    x = x.float()
    old = _den(denoise, x, np.float32(sig[0]))    # the first step: no history
    x = float(a[0]) * x - float(e[0]) * old
    _report(progress_cb, 0)
    if n > 2:
        coef = _f32(1.0 / (2.0 * (h[:-2] / h[1:-1])))   # 1 / (2 r_i)
        s_i, a32, e32 = _f32(sig[1:-2]), _f32(a[1:-1]), _f32(e[1:-1])
        for i in range(n - 2):
            den = _den(denoise, x, s_i[i])
            den_d = float(1 + coef[i]) * den - float(coef[i]) * old
            x = float(a32[i]) * x - float(e32[i]) * den_d
            old = den
            _report(progress_cb, i + 1)
    if n > 1:                                     # the last step: x = den
        den = _den(denoise, x, np.float32(sig[-2]))
        x = float(a[-1]) * x - float(e[-1]) * den
        _report(progress_cb, n - 1)
    return x


def sample_dpmpp_2m_sde(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                        eta: float = 1.0, s_noise: float = 1.0,
                        progress_cb: Progress = None):
    """The midpoint solver of k-diffusion's DPM++ 2M SDE."""
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    with np.errstate(divide="ignore"):
        t = -np.log(sig)
    h = t[1:] - t[:-1]
    eta_h = eta * h
    with np.errstate(invalid="ignore", over="ignore"):
        A = sig[1:] / sig[:-1] * np.exp(-eta_h)
        B = -np.expm1(-h - eta_h)
        ns = (sig[1:] * np.sqrt(-np.expm1(-2 * eta_h)) * s_noise if eta
              else np.zeros(n))
        r_inv = np.zeros(n)
        r_inv[1:] = h[1:] / h[:-1]
        C = 0.5 * B * r_inv
    # the first step has no history; the last one is x = denoised
    C[0], A[-1], B[-1], C[-1], ns[-1] = 0.0, 0.0, 1.0, 0.0, 0.0
    A, B, C, ns = (_f32(np.nan_to_num(v)) for v in (A, B, C, ns))
    s_i = _f32(sig[:-1])
    x = x.float()
    old = torch.zeros_like(x)
    for i in range(n):
        den = _den(denoise, x, s_i[i])
        x = float(A[i]) * x + float(B[i]) * den + float(C[i]) * (den - old)
        x = _add_noise(x, noise, i, ns[i])
        old = den
        _report(progress_cb, i)
    return x


def sample_dpmpp_3m_sde(denoise: Denoise, x, sigmas, noise: NoiseSource, *,
                        eta: float = 1.0, s_noise: float = 1.0,
                        progress_cb: Progress = None):
    sig = _check_sigmas(sigmas)
    n = len(sig) - 1
    with np.errstate(divide="ignore"):
        t = -np.log(sig)
    h = t[1:] - t[:-1]
    h_eta = h * (eta + 1)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        E = np.exp(-h_eta)
        B = -np.expm1(-h_eta)
        phi2 = np.expm1(-h_eta) / h_eta + 1.0
        phi3 = phi2 / h_eta - 0.5
        ns = (sig[1:] * np.sqrt(-np.expm1(-2 * h * eta)) * s_noise if eta
              else np.zeros(n))
        r0, r1 = np.zeros(n), np.zeros(n)
        r0[1:] = h[:-1] / h[1:]
        r1[2:] = h[:-2] / h[2:]
    E[-1], B[-1], phi2[-1], phi3[-1], ns[-1] = 0.0, 1.0, 0.0, 0.0, 0.0
    for v in (E, B, phi2, phi3, ns, r0, r1):
        np.nan_to_num(v, copy=False)
    x = x.float()
    # the two peeled warm-up steps: no history, then a first-order one
    den_1 = _den(denoise, x, np.float32(sig[0]))
    x = float(E[0]) * x + float(B[0]) * den_1
    x = _add_noise(x, noise, 0, np.float32(ns[0]))
    _report(progress_cb, 0)
    den_2 = torch.zeros_like(den_1)
    if n > 1:
        den1 = _den(denoise, x, np.float32(sig[1]))
        x = float(E[1]) * x + float(B[1]) * den1
        if phi2[1] != 0.0:
            x = x + float(phi2[1]) * ((den1 - den_1) / float(r0[1]))
        x = _add_noise(x, noise, 1, np.float32(ns[1]))
        _report(progress_cb, 1)
        den_2, den_1 = den_1, den1
    if n > 2:
        with np.errstate(divide="ignore", invalid="ignore"):
            u0 = np.where(r0 > 0, 1.0 / r0, 0.0)
            u1 = np.where(r1 > 0, 1.0 / r1, 0.0)
            inv_sum = np.where(r0 + r1 > 0, 1.0 / (r0 + r1), 0.0)
        w_r = r0 * inv_sum
        s_i, E, B, phi2, phi3, u0, u1, w_r, inv_sum, ns = (
            _f32(v) for v in (sig[:-1], E, B, phi2, phi3, u0, u1, w_r,
                              inv_sum, ns))
        for i in range(2, n):
            den = _den(denoise, x, s_i[i])
            x = float(E[i]) * x + float(B[i]) * den
            d1_0 = (den - den_1) * float(u0[i])
            d1_1 = (den_1 - den_2) * float(u1[i])
            dd1 = d1_0 + (d1_0 - d1_1) * float(w_r[i])
            dd2 = (d1_0 - d1_1) * float(inv_sum[i])
            x = x + float(phi2[i]) * dd1 - float(phi3[i]) * dd2
            x = _add_noise(x, noise, i, ns[i])
            den_2, den_1 = den_1, den
            _report(progress_cb, i)
    return x


# The menu's k-diffusion names (reference utils/sampler_utils.py), each
# with its function and sigma schedule (cremage_tpu/samplers/kdiffusion.py
# SAMPLER_SCHEDULE); DDIM, the twelfth name, is t-driven (samplers/ddim.py).
SAMPLERS = {
    "Euler": sample_euler,
    "Euler A": sample_euler_ancestral,
    "Heun": sample_heun,
    "DPM2": sample_dpm_2,
    "DPM2 A": sample_dpm_2_ancestral,
    "LMS": sample_lms,
    "DPM++ 2S A": sample_dpmpp_2s_ancestral,
    "DPM++ SDE": sample_dpmpp_sde,
    "DPM++ 2M": sample_dpmpp_2m,
    "DPM++ 2M SDE": sample_dpmpp_2m_sde,
    "DPM++ 3M SDE": sample_dpmpp_3m_sde,
}
SAMPLER_SCHEDULE = {
    "Euler": "model", "Euler A": "model", "Heun": "model", "LMS": "model",
    "DPM2": "karras", "DPM2 A": "karras", "DPM++ 2S A": "karras",
    "DPM++ SDE": "karras", "DPM++ 2M": "karras", "DPM++ 2M SDE": "karras",
    "DPM++ 3M SDE": "karras",
}
# the samplers that take Karras' churn options (s_churn, s_tmin, s_tmax,
# s_noise) from the job
CHURN_SAMPLERS = ("Euler", "Heun", "DPM2")
