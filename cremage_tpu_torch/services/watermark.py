"""Invisible watermark (the port of cremage_tpu/services/watermark.py).

Quantization-index modulation of one mid-frequency DCT coefficient of each
8x8 block of the blue channel (scipy.fft): the payload's bits repeat over
the blocks in raster order and decode by majority vote. The JAX package
transforms one block at a time; here all blocks go through one batched
`dctn` / `idctn` over the last two axes, which gives the same values, so
the output is bit-identical to the JAX package's.
"""
from __future__ import annotations

import numpy as np
from scipy.fft import dctn, idctn

_DELTA = 36.0          # quantization step (invisible at 8-bit scale)
_COEF = (3, 2)         # mid-frequency DCT coefficient per 8x8 block
_BLOCK = 8

DEFAULT_PAYLOAD = "Cremage"


def _payload_bits(payload: str) -> np.ndarray:
    return np.unpackbits(np.frombuffer(payload.encode("utf-8"), dtype=np.uint8))


def _blocks(chan: np.ndarray) -> np.ndarray:
    """(H, W) -> (H // 8, W // 8, 8, 8) view of the whole blocks."""
    nby, nbx = chan.shape[0] // _BLOCK, chan.shape[1] // _BLOCK
    return chan[:nby * _BLOCK, :nbx * _BLOCK].reshape(
        nby, _BLOCK, nbx, _BLOCK).swapaxes(1, 2)


def embed_watermark(image: np.ndarray, payload: str = DEFAULT_PAYLOAD) -> np.ndarray:
    """image: HWC uint8 or float in [0, 1]; returns the same dtype."""
    as_float = np.issubdtype(image.dtype, np.floating)
    img = (image * 255.0) if as_float else image.astype(np.float64)
    img = np.asarray(img, np.float64).copy()
    chan = img[..., 2]
    blocks = _blocks(chan)
    if blocks.size:
        bits = _payload_bits(payload)
        nby, nbx = blocks.shape[:2]
        bit = bits[np.arange(nby * nbx) % len(bits)].reshape(nby, nbx)
        d = dctn(blocks, axes=(-2, -1), norm="ortho")
        c = d[..., _COEF[0], _COEF[1]]
        q = np.round(c / _DELTA)
        # QIM: even multiples encode 0, odd encode 1
        wrong = np.mod(q.astype(np.int64), 2) != bit
        q = q + wrong * np.where(c >= q * _DELTA, 1.0, -1.0)
        d[..., _COEF[0], _COEF[1]] = q * _DELTA
        out = idctn(d, axes=(-2, -1), norm="ortho")
        chan[:nby * _BLOCK, :nbx * _BLOCK] = out.swapaxes(1, 2).reshape(
            nby * _BLOCK, nbx * _BLOCK)
    img[..., 2] = np.clip(chan, 0, 255)
    if as_float:
        return (img / 255.0).astype(image.dtype)
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


def decode_watermark(image: np.ndarray, payload_len_bytes: int) -> bytes:
    """The payload bytes that `image`'s blocks vote for."""
    as_float = np.issubdtype(image.dtype, np.floating)
    img = (image * 255.0) if as_float else image.astype(np.float64)
    blocks = _blocks(np.asarray(img, np.float64)[..., 2])
    n_bits = payload_len_bytes * 8
    coef = dctn(blocks, axes=(-2, -1), norm="ortho")[..., _COEF[0], _COEF[1]]
    bit = np.mod(np.round(coef / _DELTA).astype(np.int64), 2).reshape(-1)
    slot = np.arange(bit.size) % n_bits
    ones = np.bincount(slot, weights=bit, minlength=n_bits)
    zeros = np.bincount(slot, weights=1 - bit, minlength=n_bits)
    return np.packbits((ones > zeros).astype(np.uint8)).tobytes()
