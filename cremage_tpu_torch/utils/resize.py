"""`jax.image.resize` as the SD1.5 pipeline uses it (the port's copy of
the "nearest" and "lanczos3" methods of jax/_src/image/scale.py).

- "nearest": output index i of an axis of size in -> out samples input
  floor((i + 0.5) * in / out), computed in float32. That is torch's
  `nearest-exact`, not its `nearest` (floor(i * in / out)); the two differ
  at 8 -> 12 and 16 -> 2, for example.
- "lanczos3": per axis, a weight matrix of the Lanczos-3 kernel evaluated
  at |sample position - input index| / kernel scale (the kernel widens by
  in / out when downsampling: antialiasing), each column normalised to sum
  1, and zeroed where the sample lies outside the input. Weights are
  float32 and cast to the input's dtype; the two axes are two matmuls.
  torch has no Lanczos; bicubic differs from it by 0.22 at 8 -> 16.

`resize_area` is cv2.resize's INTER_AREA (what the JAX SVD pipeline
runs on its CLIP image), as per-axis float32 weight matrices:
- where neither axis grows, each output sample averages the input cells
  it overlaps, each weighted by its overlap over the cell's width
  (cv2's `computeResizeAreaTab`, overlaps in float64, weights rounded to
  float32, fractions under 1e-3 dropped);
- otherwise both axes take cv2's area-mode linear weights: input
  floor(i * in / out) and the next, the second weighted by the fractional
  part of (i + 1) - (floor(i * in / out) + 1) * out / in, or 0 where that
  is not positive.

Arrays are (B, H, W, C), the JAX layout; only H and W are resized.
"""
from __future__ import annotations

import numpy as np
import torch

_RADIUS = 3


def nearest_indices(n_in: int, n_out: int) -> np.ndarray:
    """Input index of each output index, in JAX's float32 arithmetic."""
    pos = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * np.float32(n_in) / np.float32(n_out)
    return np.floor(pos).astype(np.int64)


def _lanczos3(x: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        y = np.float32(_RADIUS) * np.sin(np.float32(np.pi) * x) \
            * np.sin(np.float32(np.pi) * x / np.float32(_RADIUS))
        out = np.where(x > 1e-3, y / np.where(x != 0, np.float32(np.pi**2) * x**2,
                                              np.float32(1)), np.float32(1))
    return np.where(x > _RADIUS, np.float32(0), out).astype(np.float32)


def lanczos3_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights: out[j] = sum_i in[i] * w[i, j]."""
    inv_scale = np.float32(1.0 / (n_out / n_in))     # float64, then rounded
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) \
        * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) \
        / kernel_scale
    w = _lanczos3(x.astype(np.float32))
    total = w.sum(axis=0, keepdims=True, dtype=np.float32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, np.float32(1)), np.float32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0)).astype(np.float32)


def resize(x: torch.Tensor, size, method: str) -> torch.Tensor:
    """Resize (B, H, W, C) x to (B, size[0], size[1], C) by "nearest" or
    "lanczos3"; returns x's dtype."""
    h, w = int(size[0]), int(size[1])
    if method == "nearest":
        for dim, n in ((1, h), (2, w)):
            if x.shape[dim] != n:
                idx = torch.from_numpy(nearest_indices(x.shape[dim], n))
                x = x.index_select(dim, idx.to(x.device))
        return x
    if method != "lanczos3":
        raise ValueError(f"resize method {method!r} is not ported")
    if not x.is_floating_point():
        x = x.float()
    if x.shape[1] != h:
        wh = torch.tensor(lanczos3_weights(x.shape[1], h), device=x.device,
                          dtype=x.dtype)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if x.shape[2] != w:
        ww = torch.tensor(lanczos3_weights(x.shape[2], w), device=x.device,
                          dtype=x.dtype)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x


def area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 INTER_AREA weights of an axis that does not
    grow (n_out <= n_in)."""
    scale = 1.0 / (n_out / n_in)        # as cv2 rounds it
    w = np.zeros((n_in, n_out), np.float32)
    for j in range(n_out):
        f1 = j * scale
        f2 = f1 + scale
        cell = min(scale, n_in - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_in - 1)
        s1 = min(s1, s2)
        if s1 - f1 > 1e-3:
            w[s1 - 1, j] = np.float32((s1 - f1) / cell)
        w[s1:s2, j] = np.float32(1.0 / cell)
        if f2 - s2 > 1e-3:
            w[s2, j] = np.float32(min(min(f2 - s2, 1.0), cell) / cell)
    return w


def area_linear_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of cv2's INTER_AREA where an axis of
    the call grows (its linear taps in area mode)."""
    inv = n_out / n_in
    scale = 1.0 / inv                   # as cv2 rounds it
    w = np.zeros((n_in, n_out), np.float32)
    for j in range(n_out):
        s = int(np.floor(j * scale))
        f = np.float32((j + 1) - (s + 1) * inv)
        f = np.float32(0.0) if f <= 0 else f - np.float32(np.floor(f))
        if s >= n_in - 1:
            s, f = n_in - 1, np.float32(0.0)
        w[s, j] += np.float32(1.0) - f
        if f:
            w[s + 1, j] += f
    return w


def resize_area(x: torch.Tensor, size) -> torch.Tensor:
    """cv2.resize(..., interpolation=INTER_AREA) of a float (B, H, W, C)
    tensor to (B, size[0], size[1], C), in float32."""
    h, w = int(size[0]), int(size[1])
    x = x.float()
    down = x.shape[1] >= h and x.shape[2] >= w
    fn = area_weights if down else area_linear_weights
    if x.shape[1] != h:
        wh = torch.from_numpy(fn(x.shape[1], h)).to(x.device)
        x = torch.einsum("bhwc,hH->bHwc", x, wh)
    if x.shape[2] != w:
        ww = torch.from_numpy(fn(x.shape[2], w)).to(x.device)
        x = torch.einsum("bhwc,wW->bhWc", x, ww)
    return x
