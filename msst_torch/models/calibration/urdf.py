"""URDF joint-origin writer for calibration results.

Rebuild of Multi_LiCa's ``modify_urdf_joint_origin``
(``Calibration.py:62-88``): given a URDF, update (or create) each named
joint's <origin xyz rpy> from a calibrated extrinsic pose.  A copy of
msst_tpu's numpy module that also takes the port's poses.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from .evaluation import _as_numpy


def _pose_to_xyz_rpy(pose) -> tuple[np.ndarray, np.ndarray]:
    if hasattr(pose, "to_vec6"):
        v = _as_numpy(pose.to_vec6())
        return v[3:6], v[0:3]
    T = _as_numpy(pose)
    from scipy.spatial.transform import Rotation as Rs

    return T[:3, 3], Rs.from_matrix(T[:3, :3]).as_euler("xyz")


def modify_urdf_joint_origin(urdf_path: str, joint_name: str, pose,
                             out_path: str | None = None) -> str:
    """Set <joint name=...><origin xyz=... rpy=.../> from a pose; returns the
    output path (in-place by default)."""
    tree = ET.parse(urdf_path)
    root = tree.getroot()
    xyz, rpy = _pose_to_xyz_rpy(pose)
    joint = None
    for j in root.iter("joint"):
        if j.get("name") == joint_name:
            joint = j
            break
    if joint is None:
        raise KeyError(f"joint '{joint_name}' not found in {urdf_path}")
    origin = joint.find("origin")
    if origin is None:
        origin = ET.SubElement(joint, "origin")
    origin.set("xyz", " ".join(f"{v:.6f}" for v in xyz))
    origin.set("rpy", " ".join(f"{v:.6f}" for v in rpy))
    out = out_path or urdf_path
    tree.write(out, xml_declaration=True, encoding="unicode")
    return out


def write_calibrated_urdf(urdf_path: str, joint_poses: dict, out_path: str) -> str:
    """Update several joints at once ({joint_name: pose})."""
    tmp = urdf_path
    for i, (name, pose) in enumerate(joint_poses.items()):
        tmp_out = out_path  # accumulate edits into out_path after first write
        tmp = modify_urdf_joint_origin(tmp, name, pose, tmp_out)
    return out_path
