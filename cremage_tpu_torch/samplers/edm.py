"""sgm-style EDM sampling for SDXL (the port of cremage_tpu/samplers/edm.py).

Behavior contract (sgm `modules/diffusionmodules/`):
- discretizations: LegacyDDPMDiscretization (a linspace-int subset of the
  1000-step DDPM table) and EDMDiscretization (Karras rho ramp), host
  float64 arrays, descending, with a trailing 0;
- DiscreteDenoiserSGM: sigma quantized to the nearest entry of the
  model's table, the table index fed as the network's timestep; the Eps /
  V / EDM scalings;
- guiders: VanillaCFG, one network call over [uc; c] (optionally only for
  sigma within an interval, the conditional half alone outside it),
  IdentityGuider, and SVD's LinearPredictionGuider and
  TrianglePredictionGuider, which give each of `num_frames` frames of the
  batch its own scale (one frame for images);
- the six sgm samplers run on the k-diffusion loops of
  samplers/kdiffusion.py, after sgm's input scaling x * sqrt(1 + sigma0^2)
  (prepare_sampling_loop) for txt2img.

Conditionings are dicts {"crossattn", "vector"} of tensors on the
device; noise comes from a `NoiseSource` (core/rng.py), whose step draws
stand for the JAX keys the k-diffusion scans split.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from cremage_tpu_torch.core.rng import NoiseSource
from cremage_tpu_torch.samplers import kdiffusion as K
from cremage_tpu_torch.samplers import schedules as S
from cremage_tpu_torch.samplers.denoiser import _append_dims, _bcast_sigma


def generate_roughly_equally_spaced_steps(n: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, n, endpoint=False).astype(int)[::-1]


class LegacyDDPMDiscretization:
    def __init__(self, linear_start: float = 0.00085,
                 linear_end: float = 0.0120, num_timesteps: int = 1000,
                 **_ignored):
        self.num_timesteps = num_timesteps
        self.alphas_cumprod = S.make_alphas_cumprod(num_timesteps,
                                                    linear_start, linear_end)

    def get_sigmas(self, n: int) -> np.ndarray:
        """The table subset ascending in t, returned descending."""
        if n < self.num_timesteps:
            acp = self.alphas_cumprod[
                generate_roughly_equally_spaced_steps(n, self.num_timesteps)]
        elif n == self.num_timesteps:
            acp = self.alphas_cumprod
        else:
            raise ValueError(f"n={n} > num_timesteps")
        return np.sqrt((1 - acp) / acp)[::-1].copy()

    def __call__(self, n: int, do_append_zero: bool = True) -> np.ndarray:
        s = self.get_sigmas(n)
        return S.append_zero(s) if do_append_zero else s


class EDMDiscretization:
    def __init__(self, sigma_min: float = 0.002, sigma_max: float = 80.0,
                 rho: float = 7.0, **_ignored):
        self.sigma_min, self.sigma_max, self.rho = sigma_min, sigma_max, rho

    def get_sigmas(self, n: int) -> np.ndarray:
        ramp = np.linspace(0, 1, n)
        lo = self.sigma_min ** (1 / self.rho)
        hi = self.sigma_max ** (1 / self.rho)
        return (hi + ramp * (lo - hi)) ** self.rho

    def __call__(self, n: int, do_append_zero: bool = True) -> np.ndarray:
        s = self.get_sigmas(n)
        return S.append_zero(s) if do_append_zero else s


DISCRETIZATIONS = {"LegacyDDPMDiscretization": LegacyDDPMDiscretization,
                   "EDMDiscretization": EDMDiscretization}


def make_discretization(name: str, **kwargs):
    if name not in DISCRETIZATIONS:
        raise KeyError(f"unknown discretization {name!r}; one of "
                       f"{sorted(DISCRETIZATIONS)}")
    return DISCRETIZATIONS[name](**kwargs)


# scalings: sigma -> (c_skip, c_out, c_in, c_noise), float32 tensors

def eps_scaling(sigma):
    return (torch.ones_like(sigma), -sigma, 1.0 / torch.sqrt(sigma**2 + 1.0),
            sigma)


def v_scaling(sigma):
    return (1.0 / (sigma**2 + 1.0), -sigma / torch.sqrt(sigma**2 + 1.0),
            1.0 / torch.sqrt(sigma**2 + 1.0), sigma)


def edm_scaling(sigma, sigma_data: float = 0.5):
    return (sigma_data**2 / (sigma**2 + sigma_data**2),
            sigma * sigma_data / torch.sqrt(sigma**2 + sigma_data**2),
            1.0 / torch.sqrt(sigma**2 + sigma_data**2),
            0.25 * torch.log(sigma))


SCALINGS = {"EpsScaling": eps_scaling, "VScaling": v_scaling,
            "EDMScaling": edm_scaling}


class DiscreteDenoiserSGM:
    """sgm DiscreteDenoiser: sigma quantized to the model's discrete table
    (`sigmas`, the discretization's table without the trailing 0), the
    table index fed to `network(x, t, cond)` as its timestep."""

    def __init__(self, network: Callable, sigmas: np.ndarray,
                 scaling: str = "EpsScaling", quantize_c_noise: bool = True):
        self.network = network
        # ascending in t, as the index the network takes
        self.table = np.asarray(sigmas, np.float64)[::-1].astype(np.float32)
        self.scaling = SCALINGS[scaling]
        self.quantize_c_noise = quantize_c_noise
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def _table(self, device) -> torch.Tensor:
        t = self._tables.get(device)
        if t is None:
            t = self._tables[device] = torch.from_numpy(self.table).to(device)
        return t

    def sigma_to_idx(self, sigma: torch.Tensor) -> torch.Tensor:
        table = self._table(sigma.device)
        return torch.argmin((sigma[None, :] - table[:, None]).abs(), dim=0)

    def idx_to_sigma(self, idx: torch.Tensor) -> torch.Tensor:
        return self._table(idx.device)[idx]

    def __call__(self, x: torch.Tensor, sigma, cond: Any) -> torch.Tensor:
        sigma = _bcast_sigma(sigma, x.shape[0], x.device)
        sigma_q = self.idx_to_sigma(self.sigma_to_idx(sigma))
        c_skip, c_out, c_in, c_noise = self.scaling(sigma_q)
        if self.quantize_c_noise:
            c_noise = self.sigma_to_idx(c_noise).float()
        out = self.network(x * _append_dims(c_in, x.ndim), c_noise, cond)
        return out.float() * _append_dims(c_out, x.ndim) + \
            x * _append_dims(c_skip, x.ndim)


def _cat_conds(uc: Dict, c: Dict) -> Dict:
    return {k: torch.cat([uc[k], c[k]], dim=0)
            if k in ("vector", "crossattn", "concat") else c[k] for k in c}


def vanilla_cfg(denoiser: Callable, c: Dict, uc: Dict, scale: float,
                interval=None, **_ignored) -> Callable:
    """sgm VanillaCFG: one batched call over [uc; c], then
    d_u + scale * (d_c - d_u). With `interval=(lo, hi)`, guidance only for
    lo <= sigma <= hi; outside it the conditional half runs alone."""
    cond_in = _cat_conds(uc, c)

    def denoise(x, sigma):
        b = x.shape[0]
        sigma = _bcast_sigma(sigma, b, x.device)
        if interval is not None:
            s = float(sigma.max())
            if not float(interval[0]) <= s <= float(interval[1]):
                return denoiser(x, sigma, c)
        d = denoiser(torch.cat([x, x], dim=0), torch.cat([sigma, sigma]),
                     cond_in)
        d_u, d_c = d[:b], d[b:]
        return d_u + scale * (d_c - d_u)

    return denoise


def identity_guider(denoiser: Callable, c: Dict, uc: Dict,
                    scale: float = 1.0, **_ignored) -> Callable:
    def denoise(x, sigma):
        return denoiser(x, _bcast_sigma(sigma, x.shape[0], x.device), c)

    return denoise


def _frame_scaled_cfg(denoiser: Callable, c: Dict, uc: Dict,
                      scales_per_frame: np.ndarray, num_frames: int) -> Callable:
    """CFG over [uc; c] with frame f of each num_frames-long run of the
    batch guided by scales_per_frame[f]."""
    cond_in = _cat_conds(uc, c)
    sc = torch.as_tensor(np.asarray(scales_per_frame, np.float32))

    def denoise(x, sigma):
        b = x.shape[0]
        sigma = _bcast_sigma(sigma, b, x.device)
        d = denoiser(torch.cat([x, x], dim=0), torch.cat([sigma, sigma]),
                     cond_in)
        shp = (b // num_frames, num_frames) + tuple(d.shape[1:])
        du, dc = d[:b].reshape(shp), d[b:].reshape(shp)
        scale = sc.to(d.device).reshape((1, num_frames) + (1,) * (len(shp) - 2))
        return (du + scale * (dc - du)).reshape(d[:b].shape)

    return denoise


def linear_prediction_guider(denoiser: Callable, c: Dict, uc: Dict,
                             scale: float, num_frames: int = 1,
                             min_scale: float = 1.0, max_scale=None,
                             **_ignored) -> Callable:
    """Scales linear from min_scale to max_scale over the frames."""
    max_scale = scale if max_scale is None else max_scale
    return _frame_scaled_cfg(denoiser, c, uc,
                             np.linspace(min_scale, max_scale, num_frames),
                             num_frames)


def triangle_prediction_guider(denoiser: Callable, c: Dict, uc: Dict,
                               scale: float, num_frames: int = 1,
                               min_scale: float = 1.0, max_scale=None,
                               period=1.0, period_fusing: str = "max",
                               **_ignored) -> Callable:
    """Scales on a triangle wave over the frames (each period's wave in
    [0, 1], fused by max, mean or product) from min_scale to max_scale."""
    max_scale = scale if max_scale is None else max_scale
    values = np.linspace(0, 1, num_frames)
    periods = [period] if isinstance(period, (int, float)) else list(period)
    w = np.stack([2 * np.abs(values / p - np.floor(values / p + 0.5))
                  for p in periods])
    fused = {"mean": lambda a: a.mean(0),
             "multiply": lambda a: np.prod(a, axis=0)}.get(
                 period_fusing, lambda a: a.max(0))(w)
    return _frame_scaled_cfg(denoiser, c, uc,
                             fused * (max_scale - min_scale) + min_scale,
                             num_frames)


GUIDERS = {"VanillaCFG": vanilla_cfg, "IdentityGuider": identity_guider,
           "LinearPredictionGuider": linear_prediction_guider,
           "TrianglePredictionGuider": triangle_prediction_guider}

SGM_SAMPLER_FNS = {
    "EulerEDMSampler": K.sample_euler,
    "HeunEDMSampler": K.sample_heun,
    "EulerAncestralSampler": K.sample_euler_ancestral,
    "DPMPP2SAncestralSampler": K.sample_dpmpp_2s_ancestral,
    "DPMPP2MSampler": K.sample_dpmpp_2m,
    "LinearMultistepSampler": K.sample_lms,
}
SGM_SAMPLER_NAMES = list(SGM_SAMPLER_FNS)


def run_sgm_sampler(sampler_name: str, denoise: Callable, x: torch.Tensor,
                    sigmas: np.ndarray, noise: NoiseSource, *,
                    s_churn: float = 0.0, s_tmin: float = 0.0,
                    s_tmax: float = float("inf"), s_noise: float = 1.0,
                    eta: float = 1.0, order: int = 4,
                    scale_input: bool = True, progress_cb=None) -> torch.Tensor:
    """sgm's input scaling x * sqrt(1 + sigma0^2) (txt2img; img2img passes
    its already-noised latent with scale_input=False), then the sampler."""
    sig = np.asarray(sigmas, np.float64)
    if scale_input:
        x = x.float() * float(np.sqrt(1.0 + sig[0] ** 2))
    kwargs: Dict[str, Any] = {}
    if sampler_name in ("EulerEDMSampler", "HeunEDMSampler"):
        kwargs = dict(s_churn=s_churn, s_tmin=s_tmin, s_tmax=s_tmax,
                      s_noise=s_noise)
    elif sampler_name in ("EulerAncestralSampler", "DPMPP2SAncestralSampler"):
        kwargs = dict(eta=eta, s_noise=s_noise)
    elif sampler_name == "LinearMultistepSampler":
        kwargs = dict(order=order)
    return SGM_SAMPLER_FNS[sampler_name](denoise, x, sig, noise,
                                         progress_cb=progress_cb, **kwargs)
