"""Build and load the port's CUDA kernels.

Each ``msst_torch/csrc/<name>.cu`` exposes a plain C interface.  At its
first use in a process it is compiled by ``nvcc`` for ``sm_90a`` into
``msst_torch/build/lib<name>-<source hash>.so`` (made on demand; a changed
source gets a new file name, so a stale build is never loaded) and loaded
with ``ctypes``.  The build needs the CUDA toolkit (``nvcc`` on PATH, or
under ``$CUDA_HOME`` / ``/usr/local/cuda``); nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# no --use_fast_math: the kernels' cell indices need IEEE division, and
# --fmad=false keeps a*b+c from contracting into an FMA that rounds once
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

_C = ctypes
_SIGNATURES = {
    "voxel_lookup": {
        "voxel_lookup_cat": (
            _C.c_int,
            [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int,
             _C.c_void_p, _C.c_int, _C.c_void_p, _C.c_int,
             _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
             _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p,
             _C.c_void_p, _C.c_void_p]),
    },
    "knn_query": {
        "knn_query": (
            _C.c_int,
            [_C.c_void_p, _C.c_void_p, _C.c_int,
             _C.c_void_p, _C.c_void_p, _C.c_int,
             _C.c_void_p, _C.c_void_p, _C.c_int,
             _C.c_void_p, _C.c_int, _C.c_int, _C.c_float,
             _C.c_void_p, _C.c_void_p, _C.c_void_p, _C.c_void_p]),
    },
    "gather_rows": {
        "gather_rows": (
            _C.c_int,
            [_C.c_void_p, _C.c_int, _C.c_int, _C.c_void_p, _C.c_int,
             _C.c_void_p, _C.c_int, _C.c_void_p]),
    },
}

_loaded: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"lib{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built at first use, with its C functions'
    argument and return types declared."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            getattr(lib, fn).restype = restype
            getattr(lib, fn).argtypes = argtypes
        _loaded[name] = lib
    return lib
