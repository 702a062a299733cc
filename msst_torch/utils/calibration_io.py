"""Per-laser calibration file I/O for the packet decoder.

Rebuild of the driver's calibration loader
(``timoo/src/timoo_pointcloud/src/lib/calibration.cc:40-270``: YAML with
num_lasers + per-laser rot/vert corrections and distance resolution) and of
``gen_calibration.py`` (Velodyne db.xml -> YAML converter, ``scripts/
gen_calibration.py:53-209``).  The loaded corrections feed
``packets.DecoderConfig``.

The port's own copy of ``msst_tpu.utils.calibration_io``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import math
import re
import xml.etree.ElementTree as ET


def load_calibration_yaml(path: str) -> dict:
    """Parse the reference's calibration YAML without requiring pyyaml:
    returns {num_lasers, distance_resolution, lasers: [per-laser dict]}.

    Accepts both the yaml-cpp 0.3 and 0.5 layouts the reference handles."""
    txt = open(path).read()
    out: dict = {"lasers": []}
    m = re.search(r"num_lasers:\s*(\d+)", txt)
    if m:
        out["num_lasers"] = int(m.group(1))
    m = re.search(r"distance_resolution:\s*([0-9.eE+-]+)", txt)
    if m:
        out["distance_resolution"] = float(m.group(1))
    # per-laser blocks: "- {laser_id: 0, rot_correction: ..., ...}" or
    # block style "- laser_id: 0\n  rot_correction: ..."
    flow = re.findall(r"-\s*\{([^}]*)\}", txt)
    if flow:
        for body in flow:
            entry = {}
            for kv in body.split(","):
                k, _, v = kv.partition(":")
                entry[k.strip()] = float(v)
            out["lasers"].append(entry)
    else:
        blocks = re.split(r"\n-\s", txt)
        for b in blocks[1:]:
            entry = {}
            for m2 in re.finditer(r"(\w+):\s*([0-9.eE+-]+)", b):
                entry[m2.group(1)] = float(m2.group(2))
            if "laser_id" in entry:
                out["lasers"].append(entry)
    out["lasers"].sort(key=lambda e: e.get("laser_id", 0))
    return out


def decoder_config_from_calibration(calib: dict, **overrides):
    """Build a packets.DecoderConfig from a loaded calibration, carrying the
    FULL per-laser correction set (rot/dist/two-point/offset/focal fields of
    ``calibration.h:51-73``), not just the vertical angles."""
    from .packets import DecoderConfig

    lasers = calib["lasers"]

    def col(key, default=0.0, convert=None):
        vals = [e.get(key, default) for e in lasers]
        if convert:
            vals = [convert(v) for v in vals]
        # drop all-default columns so DecoderConfig keeps its compact ()
        return tuple(vals) if any(v != default for v in vals) else ()

    vert = [math.degrees(e.get("vert_correction", 0.0)) for e in lasers]
    kw = dict(
        vert_angles_deg=tuple(vert) if vert else DecoderConfig().vert_angles_deg,
        rot_correction_deg=col("rot_correction", 0.0, math.degrees),
        dist_correction=col("dist_correction"),
        two_pt_correction_available=col("two_pt_correction_available"),
        dist_correction_x=col("dist_correction_x"),
        dist_correction_y=col("dist_correction_y"),
        vert_offset_correction=col("vert_offset_correction"),
        horiz_offset_correction=col("horiz_offset_correction"),
        focal_distance=col("focal_distance"),
        focal_slope=col("focal_slope"),
        min_intensity=col("min_intensity"),
        max_intensity=col("max_intensity", 255.0),
    )
    if lasers:
        kw["num_lasers"] = int(calib.get("num_lasers", len(lasers)))
    if "distance_resolution" in calib:
        kw["distance_resolution"] = calib["distance_resolution"]
    kw.update(overrides)
    return DecoderConfig(**kw)


def convert_velodyne_xml(xml_path: str) -> dict:
    """db.xml -> calibration dict (the gen_calibration.py role)."""
    root = ET.parse(xml_path).getroot()
    lasers = []
    for px in root.iter("px"):
        entry = {}
        for tag, key in [("id_", "laser_id"), ("rotCorrection_", "rot_correction"),
                         ("vertCorrection_", "vert_correction"),
                         ("distCorrection_", "dist_correction"),
                         ("vertOffsetCorrection_", "vert_offset_correction"),
                         ("horizOffsetCorrection_", "horiz_offset_correction")]:
            el = px.find(tag)
            if el is not None and el.text:
                v = float(el.text)
                if key in ("rot_correction", "vert_correction"):
                    v = math.radians(v)
                if key == "dist_correction":
                    v = v / 100.0  # cm -> m, like gen_calibration.py
                entry[key] = v
        if "laser_id" in entry:
            lasers.append(entry)
    lasers.sort(key=lambda e: e["laser_id"])
    return {"num_lasers": len(lasers), "lasers": lasers}


def write_calibration_yaml(path: str, calib: dict):
    lines = [f"num_lasers: {calib.get('num_lasers', len(calib['lasers']))}"]
    if "distance_resolution" in calib:
        lines.append(f"distance_resolution: {calib['distance_resolution']}")
    lines.append("lasers:")
    for e in calib["lasers"]:
        kv = ", ".join(f"{k}: {v}" for k, v in sorted(e.items()))
        lines.append(f"- {{{kv}}}")
    open(path, "w").write("\n".join(lines) + "\n")
