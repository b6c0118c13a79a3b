"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

One `nvcc` process per source compiles it for `sm_90a` (all started
together), and one more links the objects into a shared library with a
plain C interface, loaded with ctypes. The compilers' output, with
`-Xptxas -v`'s registers, spills and shared memory per kernel, is kept as
`nvcc.log` beside the library. The library lands in
`build/cremage_tpu_torch/<hash>/` beside the package, keyed by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is not. Nothing here runs at import time: the CPU tests import every
module on machines without `nvcc`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "cremage_tpu_torch"
SOURCES = ("flash_attention.cu", "groupnorm.cu")
HEADERS = ("wgmma.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib = None

_vp, _i, _i64, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
_SIGNATURES = {
    # q, k, v, o, B, H, Nq, Nk, D, scale, dp, bk, bq, stages, split, smem,
    # stream
    "cremage_flash_attention_bf16": (_vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                                     _f, _i, _i, _i, _i, _i, _i, _vp),
    # x, w, b, y, partial, N, C, HW, G, n_chunks, chunk, eps, silu, stream
    "cremage_group_norm_silu_bf16": (_vp, _vp, _vp, _vp, _vp, _i, _i, _i64,
                                     _i, _i, _i64, _f, _i, _vp),
}


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc (PATH or /usr/local/cuda)")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the current sources have no library yet;
    returns the library's path."""
    out_dir = _BUILD_ROOT / _digest()
    lib_path = out_dir / "libcremage_kernels.so"
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [Path(tmp) / (Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(_CSRC / s),
                                   "-o", str(obj)],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        if any(p.returncode != 0 for p in procs):
            raise RuntimeError(f"nvcc failed:\n{log}")
        tmp_lib = Path(tmp) / lib_path.name
        run = subprocess.run([nvcc, "-shared", *map(str, objs), "-o",
                              str(tmp_lib)],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True)
        if run.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{run.stdout}")
        (out_dir / "nvcc.log").write_text(log)
        os.replace(tmp_lib, lib_path)
    return lib_path


def kernels() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, args in _SIGNATURES.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")
