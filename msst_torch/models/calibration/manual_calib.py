"""Interactive manual extrinsic calibration, terminal version (port of
``msst_tpu.models.calibration.manual_calib``).

Rebuild of ``SensorsCalibration/lidar2lidar/manual_calib`` (Pangolin GL tool,
``run_lidar2lidar.cpp:31-493``): keyboard nudges adjust the source->target
extrinsic with an adjustable step, and the result saves as the same JSON
layout (``extrinsic_param.hpp``).  Instead of a GL render, each nudge reports
an alignment score (mean NN distance + inlier fraction, the NN one launch of
kernel B2 on the card), scriptable and usable over ssh.

Keymap (matches ``lidar2lidar/README.md:52-62``):
    q/a  +-roll     w/s  +-pitch    e/d  +-yaw
    r/f  +-x        t/g  +-y        y/h  +-z
    u/j  double/halve the step      p    print extrinsic
    z    save JSON and exit         x    exit without saving
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np
import torch

from ...ops import knn, se3
from . import device as device_mod


class ManualCalibrator:
    def __init__(self, source_xyz: np.ndarray, target_xyz: np.ndarray,
                 init_pose: Optional[se3.Pose] = None,
                 rot_step_deg: float = 0.3, trans_step: float = 0.06,
                 device="cuda"):
        self.device = device_mod.resolve(device)
        self.src = torch.from_numpy(np.asarray(source_xyz, np.float32)).to(
            self.device)
        tgt = torch.from_numpy(np.asarray(target_xyz, np.float32)).to(
            self.device)
        self.grid = knn.build(tgt, torch.ones(len(target_xyz), dtype=torch.bool,
                                              device=self.device),
                              cell_size=1.0, table_size=16384)
        self._src_mask = torch.ones(self.src.shape[0], dtype=torch.bool,
                                    device=self.device)
        self.pose = init_pose or se3.Pose.identity(device=self.device)
        self.rot_step = np.radians(rot_step_deg)
        self.trans_step = trans_step

    def _score(self, pose: se3.Pose):
        res = knn.query(self.grid, pose.apply(self.src), self._src_mask, k=1,
                        candidates_per_cell=16, max_sqdist=1.0)
        ok = res.valid[:, 0]
        n = torch.clamp(torch.sum(ok.to(torch.int32)), min=1)
        mean_d = torch.sum(torch.where(ok, torch.sqrt(res.sqdist[:, 0]),
                                       0.0)) / n
        return mean_d, torch.mean(ok.to(torch.float32))

    def score(self):
        d, f = self._score(self.pose)
        return float(d), float(f)

    def nudge(self, key: str) -> bool:
        """Apply one keymap action; returns False on the exit keys."""
        rs, ts = self.rot_step, self.trans_step
        deltas = {
            "q": (0, rs), "a": (0, -rs), "w": (1, rs), "s": (1, -rs),
            "e": (2, rs), "d": (2, -rs),
            "r": (3, ts), "f": (3, -ts), "t": (4, ts), "g": (4, -ts),
            "y": (5, ts), "h": (5, -ts),
        }
        if key in deltas:
            axis, amt = deltas[key]
            v6 = self.pose.to_vec6().detach().cpu().numpy().copy()
            v6[axis] += amt
            self.pose = se3.Pose.from_vec6(torch.from_numpy(v6).to(self.device))
            return True
        if key == "u":
            self.rot_step *= 2.0
            self.trans_step *= 2.0
            return True
        if key == "j":
            self.rot_step *= 0.5
            self.trans_step *= 0.5
            return True
        if key == "p":
            print(self.extrinsic_json())
            return True
        return key not in ("z", "x")

    def extrinsic_json(self) -> str:
        """The JSON layout of the reference's saveResult (extrinsic_param)."""
        T = self.pose.to_matrix().detach().cpu().numpy()
        return json.dumps({
            "extrinsic": {
                "rotation": T[:3, :3].tolist(),
                "translation": T[:3, 3].tolist(),
                "matrix": T.tolist(),
            }
        }, indent=2)

    def save(self, path: str):
        with open(path, "w") as f:
            f.write(self.extrinsic_json())

    def run_interactive(self):  # pragma: no cover - needs a tty
        print(__doc__)
        while True:
            d, frac = self.score()
            print(f"mean NN dist {d*100:.2f} cm | matched {frac*100:.1f}% | "
                  f"step {np.degrees(self.rot_step):.2f} deg / "
                  f"{self.trans_step*100:.1f} cm")
            key = input("key> ").strip()[:1]
            if not self.nudge(key):
                if key == "z":
                    self.save("extrinsic.json")
                    print("saved extrinsic.json")
                break
