"""The app's data directory (the port's copy of the parts of
cremage_tpu/app/dirs.py the server needs): ~/.cremage_tpu with its
subdirectories. /v1/upload stages input images under `tmp`, and a job with
`result_delivery: "path"` has its PNG written under `outputs`, whose path
the status channel then carries. The JAX package uses the same directory,
so both servers read each other's files.
"""
from __future__ import annotations

import itertools
import os
import time
from typing import Optional

APP_DIR_NAME = ".cremage_tpu"
SUBDIRS = ("tmp", "outputs", "trash", "favorites", "data/faces",
           "embedding_images", "tmp/svd/frames")


def app_root(base: Optional[str] = None) -> str:
    return base or os.path.join(os.path.expanduser("~"), APP_DIR_NAME)


def first_init(base: Optional[str] = None) -> str:
    """The app root with every subdirectory of SUBDIRS, created if
    missing."""
    root = app_root(base)
    for sub in SUBDIRS:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    return root


def upload_dir() -> str:
    """`~/.cremage_tpu/tmp`, created if missing."""
    d = os.path.join(app_root(), "tmp")
    os.makedirs(d, exist_ok=True)
    return d


_output_seq = itertools.count(1)     # next() is atomic under the GIL


def save_output_image(root: str, png_bytes: bytes) -> str:
    """Write a generated PNG into `root`/outputs as
    <date>-<time>_<sequence>.png (chronological, unique names, as JAX
    names them); returns its path."""
    d = os.path.join(root, "outputs")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "%s_%06d.png" % (time.strftime("%Y%m%d-%H%M%S"),
                                            next(_output_seq)))
    with open(path, "wb") as f:
        f.write(png_bytes)
    return path
