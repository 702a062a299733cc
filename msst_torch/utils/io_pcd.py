"""PCD file I/O (the part of ``msst_tpu.utils.io_pcd`` the port needs,
copied so that the port imports nothing of msst_tpu): ``write_pcd`` for
``LioSam.save_map``, PCD v0.7 float32 fields, binary or ascii; ``read_pcd``
for the calibration CLI, ascii, binary and binary_compressed (LZF) with
arbitrary scalar fields."""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np


def write_pcd(path: str, xyz: np.ndarray, intensity: Optional[np.ndarray] = None,
              binary: bool = True):
    n = len(xyz)
    fields = ["x", "y", "z"] + (["intensity"] if intensity is not None else [])
    k = len(fields)
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format",
        "VERSION 0.7",
        f"FIELDS {' '.join(fields)}",
        f"SIZE {' '.join(['4'] * k)}",
        f"TYPE {' '.join(['F'] * k)}",
        f"COUNT {' '.join(['1'] * k)}",
        f"WIDTH {n}",
        "HEIGHT 1",
        "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {n}",
        f"DATA {'binary' if binary else 'ascii'}",
    ]) + "\n"
    cols = [np.asarray(xyz, np.float32)]
    if intensity is not None:
        cols.append(np.asarray(intensity, np.float32).reshape(-1, 1))
    data = np.concatenate(cols, axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(data.tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def lzf_decompress(data: bytes, expected_size: int) -> bytes:
    """Pure-Python libLZF decompressor (the PCL binary_compressed codec)."""
    out = bytearray(expected_size)
    i, o, n = 0, 0, len(data)
    while i < n and o < expected_size:
        ctrl = data[i]
        i += 1
        if ctrl < 32:  # literal run of ctrl+1 bytes
            run = ctrl + 1
            out[o:o + run] = data[i:i + run]
            i += run
            o += run
        else:  # back reference
            length = ctrl >> 5
            if length == 7:
                length += data[i]
                i += 1
            ref = o - ((ctrl & 0x1F) << 8) - data[i] - 1
            i += 1
            length += 2
            if ref + length <= o:  # non-overlapping: block copy
                out[o:o + length] = out[ref:ref + length]
                o += length
            else:  # overlapping run: byte-wise
                for _ in range(length):
                    out[o] = out[ref]
                    o += 1
                    ref += 1
    return bytes(out[:o])

_TYPEMAP = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
}


def read_pcd(path: str) -> dict:
    """Returns {"xyz": (N,3) f32, "fields": {name: (N,) array}}."""
    with open(path, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if not line or line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get("COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        mode = header["DATA"]

        dtypes = []
        for name, t, s, c in zip(fields, types, sizes, counts):
            base = _TYPEMAP[(t, s)]
            if c == 1:
                dtypes.append((name, base))
            else:
                dtypes.append((name, base, (c,)))
        dt = np.dtype(dtypes)

        if mode == "ascii":
            raw = np.loadtxt(f, dtype=np.float64, max_rows=n)
            raw = np.atleast_2d(raw)
            rec = np.zeros(n, dt)
            col = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                w = c
                vals = raw[:, col:col + w]
                rec[name] = vals[:, 0] if w == 1 else vals
                col += w
        elif mode == "binary":
            rec = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        elif mode == "binary_compressed":
            # [u32 compressed_size][u32 uncompressed_size][LZF data], with
            # the uncompressed payload laid out field-major (SOA)
            comp_size, uncomp_size = struct.unpack("<II", f.read(8))
            buf = lzf_decompress(f.read(comp_size), uncomp_size)
            rec = np.zeros(n, dt)
            off = 0
            for name, t, s, c in zip(fields, types, sizes, counts):
                base = _TYPEMAP[(t, s)]
                width = s * c * n
                col = np.frombuffer(buf[off:off + width], dtype=base)
                rec[name] = col.reshape(n, c) if c > 1 else col[:n]
                off += width
        else:
            raise ValueError(f"unsupported PCD DATA mode: {mode}")

    out_fields = {name: np.asarray(rec[name]) for name in rec.dtype.names}
    xyz = np.stack([out_fields.get(k, np.zeros(n)) for k in ("x", "y", "z")],
                   axis=1).astype(np.float32)
    return {"xyz": xyz, "fields": out_fields}
