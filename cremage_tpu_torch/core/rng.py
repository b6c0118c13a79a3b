"""Seed / RNG semantics and the sampler's noise sources.

Behavior contract with the reference (as cremage_tpu/core/rng.py):
- a job seed of -1 means "draw a fresh random seed";
- image ``i`` of a batch job uses ``seed + i``: the noise of a batch
  starting at image index i comes from seed + i.

torch cannot reproduce JAX's threefry keys, so the pipeline draws its
initial and per-step noise from an injectable `NoiseSource`. The default
is `GeneratorNoise`, a `torch.Generator` on the pipeline's device seeded
with seed + index; parity tests pass an `ArrayNoise` holding the arrays
the JAX pipeline drew. Noise is drawn in float32, in the JAX layout
(NHWC latents).
"""
from __future__ import annotations

import secrets
from typing import Protocol, Sequence, Tuple

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

    def step(self, i: int, shape: Tuple[int, ...]) -> torch.Tensor:
        """Standard-normal noise of sampler step i."""


class GeneratorNoise:
    """Default source: one torch.Generator per batch, seeded with
    seed + image index, on the pipeline's device."""

    def __init__(self, seed: int, device: torch.device):
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def initial(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32)

    def step(self, i, shape):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=torch.float32)


class ArrayNoise:
    """Noise handed over as arrays (the initial noise, then one array per
    sampler step), e.g. the ones the JAX pipeline drew."""

    def __init__(self, initial: np.ndarray, steps: Sequence[np.ndarray],
                 device):
        self.device = torch.device(device)
        self._initial = initial
        self._steps = list(steps)

    def _take(self, arr, shape):
        t = torch.tensor(np.asarray(arr, np.float32), device=self.device)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"noise shape {tuple(t.shape)} != {tuple(shape)}")
        return t

    def initial(self, shape):
        return self._take(self._initial, shape)

    def step(self, i, shape):
        return self._take(self._steps[i], shape)
