"""PNG encode/decode with zlib + struct (the port's counterpart of the PIL
calls in cremage_tpu/io/metadata.py and app/worker.py).

Writes 8-bit RGB PNGs with a `tEXt` chunk per metadata key (the job's
`generation_data` JSON), and reads such files back: enough for the serving
path and its checks without an imaging library.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

GENERATION_DATA_KEY = "generation_data"
_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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


def decode_png(data: bytes) -> Tuple[np.ndarray, Dict[str, str]]:
    """PNG bytes as `encode_png` writes them (8-bit RGB, not interlaced,
    no row filters) -> ((H, W, 3) uint8, tEXt items). Raises ValueError
    on anything else or a bad checksum."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG")
    pos, idat, text, hdr = len(_SIGNATURE), [], {}, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r} chunk")
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tEXt":
            k, _, v = body.partition(b"\0")
            text[k.decode("latin-1")] = v.decode("latin-1")
        elif kind == b"IEND":
            break
    if hdr is None or hdr[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"unsupported PNG header {hdr}")
    w, h = hdr[0], hdr[1]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, w * 3 + 1)
    if rows[:, 0].any():
        raise ValueError("PNG row filters are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy(), text
