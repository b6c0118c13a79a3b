"""Seed / RNG semantics and the samplers' noise sources.

Behavior contract with the reference (as cremage_tpu/core/rng.py):
- a job seed of -1 means "draw a fresh random seed";
- image ``i`` of a batch job uses ``seed + i``: the noise of a batch
  starting at image index i comes from seed + i.

torch cannot reproduce JAX's threefry keys, so the pipeline draws every
random number from an injectable `NoiseSource`. The default is
`GeneratorNoise`, one `torch.Generator` on the pipeline's device seeded
with seed + index; parity tests pass an `ArrayNoise` holding the arrays
the JAX pipeline drew. Noise is drawn in float32, in the JAX layout (NHWC
latents). The draws of one batch, with the JAX key each stands for
(`key` = key_for_image(seed, index)):

- `initial`: the initial latent noise, normal(key);
- `encode`: the img2img / hires stochastic encode's noise (k-space or
  DDIM), normal(key) at the sampling shape;
- `step(i, shape, draw)`: draw `draw` of sampler step i, from
  split(key, n * per_step).reshape(n, per_step)[i, draw] (DPM++ SDE makes
  two draws a step, LCM's re-noise and every other sampler one);
- `posterior`: the VAE posterior sample of img2img's init image,
  normal(fold_in(key, 7));
- `cond_aug`: the noise SVD adds to its conditioning frame,
  normal(fold_in(key, 3));
- `hires()`: the source of the hires fix's second pass, whose key is
  fold_in(key, 1);
- `refiner()`: the source of the SDXL refiner's pass, whose key is
  fold_in(key, 99) (its `encode` noises the base latent, its `step` draws
  are the refiner sampler's);
- `prior()`: the source of Kandinsky 2.2's prior, whose key is
  fold_in(key, 1) (its `initial` is the noisy image embedding, its `step`
  draws the prior sampler's).
"""
from __future__ import annotations

import secrets
from typing import Optional, Protocol, Sequence, Tuple

import numpy as np
import torch

# Max value for drawn seeds; reference uses 32-bit-ish UI-safe ints.
_SEED_MAX = 2**31 - 1


def resolve_seed(seed) -> int:
    """Resolve a job seed: -1/None draws a fresh random seed (host-side)."""
    if seed is None or int(seed) < 0:
        return secrets.randbelow(_SEED_MAX)
    return int(seed)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.
    Never falls back to the CPU silently."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "on the CPU")
    return torch.device("cuda")


class NoiseSource(Protocol):
    def initial(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard-normal initial latent noise."""

    def encode(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard-normal noise of a stochastic encode (img2img, hires)."""

    def step(self, i: int, shape: Tuple[int, ...],
             draw: int = 0) -> torch.Tensor:
        """Standard-normal noise `draw` of sampler step i."""

    def posterior(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard-normal noise of the VAE posterior sample."""

    def cond_aug(self, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard-normal noise of SVD's conditioning-frame augmentation."""

    def hires(self) -> "NoiseSource":
        """The noise source of the hires fix's second pass."""

    def refiner(self) -> "NoiseSource":
        """The noise source of the SDXL refiner's pass."""

    def prior(self) -> "NoiseSource":
        """The noise source of Kandinsky 2.2's prior."""


class GeneratorNoise:
    """Default source: one torch.Generator per batch, seeded with
    seed + image index, on the pipeline's device. Every draw, the hires,
    refiner and prior passes' included, comes from it in the order the
    pipeline asks."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def _draw(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def initial(self, shape):
        return self._draw(shape)

    def encode(self, shape):
        return self._draw(shape)

    def step(self, i, shape, draw=0):
        return self._draw(shape)

    def posterior(self, shape):
        return self._draw(shape)

    def cond_aug(self, shape):
        return self._draw(shape)

    def hires(self):
        return self

    def refiner(self):
        return self

    def prior(self):
        return self


class ArrayNoise:
    """Noise handed over as arrays, e.g. the ones the JAX pipeline drew:
    the initial noise, then one entry per sampler step (an array, or a
    sequence of arrays where a step makes several draws), and optionally
    the encode, posterior and conditioning-augmentation noise and the hires,
    refiner and prior passes' own ArrayNoise. Asking for a draw that was not
    handed over raises."""

    def __init__(self, initial: Optional[np.ndarray],
                 steps: Sequence = (), device="cpu", *,
                 encode: Optional[np.ndarray] = None,
                 posterior: Optional[np.ndarray] = None,
                 cond_aug: Optional[np.ndarray] = None,
                 hires: Optional["ArrayNoise"] = None,
                 refiner: Optional["ArrayNoise"] = None,
                 prior: Optional["ArrayNoise"] = None):
        self.device = torch.device(device)
        self._initial = initial
        self._steps = list(steps)
        self._encode = encode
        self._posterior = posterior
        self._cond_aug = cond_aug
        self._passes = {"hires": hires, "refiner": refiner, "prior": prior}

    def _take(self, arr, shape, what):
        if arr is None:
            raise ValueError(f"ArrayNoise: no {what} noise was handed over")
        t = torch.tensor(np.asarray(arr, np.float32), device=self.device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what} noise shape {tuple(t.shape)} != "
                             f"{tuple(shape)}")
        return t

    def initial(self, shape):
        return self._take(self._initial, shape, "initial")

    def encode(self, shape):
        return self._take(self._encode, shape, "encode")

    def step(self, i, shape, draw=0):
        s = self._steps[i]
        if isinstance(s, (list, tuple)):
            s = s[draw]
        elif draw:
            raise ValueError(f"ArrayNoise: step {i} holds one draw")
        return self._take(s, shape, f"step {i}")

    def posterior(self, shape):
        return self._take(self._posterior, shape, "posterior")

    def cond_aug(self, shape):
        return self._take(self._cond_aug, shape, "cond_aug")

    def _pass(self, what):
        if self._passes[what] is None:
            raise ValueError(f"ArrayNoise: no {what} noise was handed over")
        return self._passes[what]

    def hires(self):
        return self._pass("hires")

    def refiner(self):
        return self._pass("refiner")

    def prior(self):
        return self._pass("prior")
