"""The port's host library, ``msst_torch/native/msst_native.cc``: the batch
packet decoder, the pcap reader, live UDP capture, a packet ring buffer and
the int16 point packer of LioSam's window uploads, behind a plain C
interface.

At its first use in a process the source is compiled by the host C++
compiler (``$CXX``, else ``g++``) with ``-O3 -fPIC -std=c++17 -shared`` into
``msst_torch/build/libmsst_native-<hash>.so`` (a changed source gets a new
file name, so a stale build is never loaded) and loaded with ``ctypes``.  A
failed build raises with the compiler's output: nothing falls back to the
numpy decoder unless a caller asks for it (``packets.decode_packets(...,
force_numpy=True)``).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "msst_native.cc"
BUILD = _PKG / "build"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
PACKET_SIZE = 1206

_C = ctypes
_SIGNATURES = {
    "decode_packets": (_C.c_int, [_C.c_void_p, _C.c_int, _C.c_void_p]
                       + 8 * [_C.c_void_p]),
    "pcap_read_packets": (_C.c_int, [_C.c_char_p, _C.c_void_p, _C.c_void_p,
                                     _C.c_int]),
    "udp_open": (_C.c_int, [_C.c_int, _C.c_int]),
    "udp_recv_batch": (_C.c_int, [_C.c_int, _C.c_void_p, _C.c_int, _C.c_int]),
    "udp_close": (None, [_C.c_int]),
    "ring_create": (_C.c_void_p, [_C.c_int]),
    "ring_push": (_C.c_int, [_C.c_void_p, _C.c_void_p, _C.c_double]),
    "ring_pop_batch": (_C.c_int, [_C.c_void_p, _C.c_void_p, _C.c_void_p,
                                  _C.c_int]),
    "ring_size": (_C.c_int, [_C.c_void_p]),
    "ring_destroy": (None, [_C.c_void_p]),
    "pack_scan_q16": (None, 3 * [_C.c_void_p] + 2 * [_C.c_int]
                      + 2 * [_C.c_void_p]),
}

_lib = None


def _compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("no C++ compiler: the packet decoder needs g++ "
                           "(or $CXX) to build msst_torch/native/"
                           "msst_native.cc")
    return cxx


def library_path(source=None) -> Path:
    source = Path(source or SOURCE)
    digest = hashlib.sha256(source.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD / f"libmsst_native-{digest}.so"


def build(source=None) -> Path:
    """Compile `source` (the library's source unless given) unless its
    library is already built; raises RuntimeError with the compiler's
    stderr where the build fails."""
    source = Path(source or SOURCE)
    out = library_path(source)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
    os.close(fd)
    try:
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp,
                               str(source)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {source.name} failed:\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load() -> ctypes.CDLL:
    """The library (built at the first call), with its C signatures."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, (restype, argtypes) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
    return _lib


def read_pcap(path: str, max_packets: int) -> tuple[np.ndarray, np.ndarray]:
    """The first `max_packets` 1206-byte UDP payloads of a classic pcap (the
    InputPCAP role): ((n, 1206) uint8 packets, (n,) float64 capture stamps in
    seconds).  Raises OSError where the file cannot be read as a pcap."""
    out = np.empty((max_packets, PACKET_SIZE), np.uint8)
    stamps = np.empty(max_packets, np.float64)
    n = load().pcap_read_packets(os.fsencode(path), out.ctypes.data,
                                 stamps.ctypes.data, max_packets)
    if n < 0:
        raise OSError(f"pcap read failed ({n}): {path}")
    return out[:n], stamps[:n]


def pack_scan_q16(xyz, time_rel, ring, max_points: int, scales: np.ndarray,
                  out: np.ndarray) -> int:
    """Quantize a scan's first min(len(xyz), max_points) points into `out`,
    a contiguous int16 array of max_points*5 (rows [x, y, z, time_rel,
    ring] times `scales`, rounded half to even, clipped to +-32767; rows
    past the scan zeroed).  Returns the number of points packed."""
    n = min(len(xyz), max_points)
    xyz32 = np.ascontiguousarray(np.asarray(xyz, np.float32)[:n])
    t32 = np.ascontiguousarray(np.asarray(time_rel, np.float32)[:n])
    r32 = np.ascontiguousarray(np.asarray(ring, np.int32)[:n])
    scales = np.ascontiguousarray(scales, np.float32)
    if out.dtype != np.int16 or out.size != max_points * 5 or not (
            out.flags.c_contiguous):
        raise ValueError("out must be a contiguous int16 array of "
                         f"{max_points * 5}")
    load().pack_scan_q16(xyz32.ctypes.data, t32.ctypes.data, r32.ctypes.data,
                         n, max_points, scales.ctypes.data, out.ctypes.data)
    return n
