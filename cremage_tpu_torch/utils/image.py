"""Decoded images to host pixels (the port of cremage_tpu/utils/image.py
`device_to_img01`)."""
from __future__ import annotations

import numpy as np
import torch


def device_to_img01(imgs: torch.Tensor) -> np.ndarray:
    """Device [-1, 1] decode output -> host float [0, 1], quantized to uint8
    ON THE DEVICE before the copy (the serving path ships 8-bit PNG pixels
    anyway, and uint8 moves a quarter of the fp32 bytes). /255 restores the
    float API for the callers at PNG-identical precision."""
    q = torch.clamp((imgs.float() + 1.0) * 127.5 + 0.5, 0, 255).to(torch.uint8)
    return q.cpu().numpy().astype(np.float32) / 255.0
