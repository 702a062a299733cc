"""PCD file output for ``LioSam.save_map`` (the part of
``msst_tpu.utils.io_pcd`` the port needs, copied so that the port imports
nothing of msst_tpu): PCD v0.7, float32 fields, binary or ascii."""

from __future__ import annotations

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
