"""PNG generation metadata (the port's copy of `read_generation_data` of
cremage_tpu/io/metadata.py): every generated PNG carries its generation
parameters as JSON in the tEXt key `generation_data` (io/png.py
`encode_png`), and a past image's parameters can be read back as the
options of a new job. Read with the port's own PNG reader: the card's
machine has no PIL.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional

from cremage_tpu_torch.io.png import GENERATION_DATA_KEY, png_text


def read_generation_data(path: str) -> Optional[Dict[str, Any]]:
    """The `generation_data` JSON of the PNG at `path`; None where it has no
    such chunk or the chunk is not JSON, as in JAX."""
    with open(path, "rb") as f:
        raw = png_text(f.read()).get(GENERATION_DATA_KEY)
    if raw is None:
        return None
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return None
