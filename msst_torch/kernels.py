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
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "build"

# no --use_fast_math: the kernels' cell indices need IEEE division, and
# --fmad=false keeps a*b+c from contracting into an FMA that rounds once;
# -Xptxas -v reports each kernel's registers and spills (resource_usage)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]

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
        "knn_query_cat": (
            _C.c_int,
            [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_int]
            + 2 * [_C.c_void_p, _C.c_void_p, _C.c_int, _C.c_void_p,
                   _C.c_void_p, _C.c_int, _C.c_void_p]
            + [_C.c_int, _C.c_int, _C.c_float,
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
        _report_path(out).write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def check_tensors(names, tensors, dtypes, device: int) -> None:
    """Raise ValueError unless each tensor is contiguous, of its dtype and
    on `device` (a device index, -1 for the CPU): the checks every kernel
    wrapper makes before it launches."""
    for name, t, dtype in zip(names, tensors, dtypes):
        if (t.get_device() != device or t.dtype is not dtype
                or not t.is_contiguous()):
            if t.get_device() != device:
                raise ValueError(f"{name} is on {t.device}, not with the "
                                 "other inputs")
            if t.dtype is not dtype:
                raise ValueError(f"{name} must be {dtype}")
            raise ValueError(f"{name} must be contiguous")


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def _short_name(mangled: str) -> str:
    """``knn_query_kernel<5, 16>`` for a kernel's mangled name (c++filt
    where the toolchain has it, else the mangled name)."""
    try:
        name = subprocess.run(["c++filt", mangled], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return mangled
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"(?:void )?([\w:]+(?:<[^()]*>)?)", name)
    return m.group(1) if m else name


def resource_usage(name: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} of
    ``csrc/<name>.cu``, from ``nvcc -Xptxas -v`` at its build (empty where
    the library was built without that report)."""
    report = _report_path(library_path(name))
    if not report.exists():
        return {}
    usage, fn, spills = {}, None, (0, 0)
    for line in report.read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn is not None:
            usage[_short_name(fn)] = (int(m.group(1)),) + spills
            fn = None
    return usage


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
