"""PNG encode/decode with zlib + struct (the port's counterpart of the PIL
calls in cremage_tpu/io/metadata.py, app/worker.py and app/backends.py).

Writes 8-bit RGB PNGs with a `tEXt` chunk per metadata key (the job's
`generation_data` JSON). Reads 8-bit, non-interlaced PNGs of every colour
type (grey, grey + alpha, RGB, RGBA, palette) with any of the five row
filters, and converts them as PIL's `Image.convert` does: to "RGB" by
dropping alpha (no compositing) and expanding grey and palette entries; to
"L" by (19595 R + 38470 G + 7471 B + 0x8000) >> 16, with grey taken as is.
Other bit depths and interlaced files raise ValueError.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

GENERATION_DATA_KEY = "generation_data"
_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel: grey, RGB, palette, grey + alpha, RGBA
_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def image_to_uint8(img01: np.ndarray) -> np.ndarray:
    """float [0, 1] HWC image -> uint8 RGB, rounded as
    cremage_tpu/io/metadata.py `image_from_array` does."""
    a = np.clip(np.asarray(img01, np.float32), 0.0, 1.0)
    return (a * 255).round().astype(np.uint8)


def encode_png(rgb: np.ndarray, text: Dict[str, str] = None) -> bytes:
    """(H, W, 3) uint8 -> PNG bytes with one tEXt chunk per `text` item."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1)                      # filter byte 0 per row
    out = [_SIGNATURE,
           _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    for k, v in (text or {}).items():
        out.append(_chunk(b"tEXt", k.encode("latin-1") + b"\0"
                          + v.encode("latin-1", errors="replace")))
    out.append(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG spec section 9) -> (h, w * bpp).

    A byte depends on its left, upper and upper-left neighbours, so every
    pixel of an anti-diagonal (row + column = d) depends only on the two
    diagonals before it: one numpy step per diagonal, h + w - 1 steps,
    each over all of the diagonal's pixels with the filter of its row."""
    stride = w * bpp
    rows = np.frombuffer(raw, np.uint8)
    if rows.size < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = rows[:h * (stride + 1)].reshape(h, stride + 1)
    kinds, data = rows[:, 0], rows[:, 1:]
    if (kinds > 4).any():
        raise ValueError(f"bad PNG row filter {int(kinds.max())}")
    if not kinds.any():
        return data.copy()
    f = np.ascontiguousarray(data).reshape(h * w, bpp)
    out = np.empty((h * w, bpp), np.uint8)
    kind = kinds[:, None]
    # the last two diagonals, indexed by row + 1: index 0 is the zero row
    # above the image, and a pixel left of column 0 is never written (0)
    prev = np.zeros((h + 1, bpp), np.int16)
    prev2 = prev
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h, d + 1)
        a, b, c = prev[r0 + 1:r1 + 1], prev[r0:r1], prev2[r0:r1]
        k = kind[r0:r1]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.where(k == 4, paeth, np.where(
            k == 3, (a + b) >> 1, np.where(k == 2, b, np.where(k == 1, a, 0))))
        # pixel (r, d - r) is at r * (w - 1) + d (one pixel a diagonal
        # when w == 1, where any step will do)
        pixels = slice(r0 * (w - 1) + d, (r1 - 1) * (w - 1) + d + 1,
                       max(w - 1, 1))
        cur = np.zeros((h + 1, bpp), np.int16)
        cur[r0 + 1:r1 + 1] = (f[pixels] + pred) & 0xFF
        out[pixels] = cur[r0 + 1:r1 + 1]
        prev2, prev = prev, cur
    return out.reshape(h, stride)


def _to_l(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((19595 * r + 38470 * g + 7471 * b + 0x8000) >> 16).astype(np.uint8)


def _chunks(data: bytes):
    """(kind, body) of each chunk of PNG bytes up to IEND, CRCs checked."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG")
    pos = len(_SIGNATURE)
    while pos + 12 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r} chunk")
        pos += 12 + n
        if kind == b"IEND":
            return
        yield kind, body


def _text_item(body: bytes) -> Tuple[str, str]:
    k, _, v = body.partition(b"\0")
    return k.decode("latin-1"), v.decode("latin-1")


def png_text(data: bytes) -> Dict[str, str]:
    """The tEXt items of PNG bytes, the pixels left undecoded."""
    return dict(_text_item(body) for kind, body in _chunks(data)
                if kind == b"tEXt")


def decode_png(data: bytes, mode: str = "RGB",
               max_edge: Optional[int] = None
               ) -> Tuple[np.ndarray, Dict[str, str]]:
    """PNG bytes -> (pixels, tEXt items): (H, W, 3) uint8 for mode "RGB",
    (H, W) uint8 for mode "L", converted as PIL's `convert(mode)` does.
    Raises ValueError on a bad checksum, a bit depth other than 8, an
    interlaced file, an edge above `max_edge` (checked against the header,
    before anything is inflated) or anything else it cannot read. The
    image data is inflated to the size the header gives and no further."""
    if mode not in ("RGB", "L"):
        raise ValueError(f"decode_png: mode {mode!r} is not one of RGB, L")
    idat, text, hdr, palette = [], {}, None, None
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            text.update([_text_item(body)])
    if hdr is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, comp, filt, interlace = hdr
    if depth != 8 or ctype not in _SAMPLES or comp or filt:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type "
                         f"{ctype} (8-bit grey, grey + alpha, RGB, RGBA and "
                         "palette PNGs are read)")
    if interlace:
        raise ValueError("unsupported PNG: interlaced (Adam7)")
    if not (w and h):
        raise ValueError("PNG of zero pixels")
    if max_edge is not None and max(w, h) > max_edge:
        raise ValueError(f"PNG of {w}x{h} pixels: image edge exceeds "
                         f"{max_edge}")
    bpp = _SAMPLES[ctype]
    raw = zlib.decompressobj().decompress(b"".join(idat), h * (w * bpp + 1))
    px = _unfilter(raw, h, w, bpp).reshape(h, w, bpp)
    if ctype in (0, 4):                                  # grey (+ alpha)
        grey = px[..., 0]
        out = grey.copy() if mode == "L" else np.repeat(grey[..., None], 3, -1)
        return out, text
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without a PLTE chunk")
        table = np.zeros((256, 3), np.uint8)
        table[:len(palette)] = palette[:256]
        rgb = table[px[..., 0]]
    else:                                                # RGB(A): drop alpha
        rgb = px[..., :3].copy()
    return (_to_l(rgb) if mode == "L" else rgb), text


def read_png(path: str, mode: str = "RGB",
             max_edge: Optional[int] = None) -> np.ndarray:
    """The pixels of the PNG file at `path` (see `decode_png`)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), mode, max_edge)[0]
