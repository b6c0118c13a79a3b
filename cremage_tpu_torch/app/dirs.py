"""The app's data directory (the port's copy of the part of
cremage_tpu/app/dirs.py the server needs): ~/.cremage_tpu with its `tmp`
directory, where /v1/upload stages input images. The JAX package uses the
same directory, so both servers read each other's staged files.
"""
from __future__ import annotations

import os

APP_DIR_NAME = ".cremage_tpu"


def upload_dir() -> str:
    """`~/.cremage_tpu/tmp`, created if missing."""
    d = os.path.join(os.path.expanduser("~"), APP_DIR_NAME, "tmp")
    os.makedirs(d, exist_ok=True)
    return d
