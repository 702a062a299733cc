"""A checkout-shaped directory holding tiny cells, for the CPU tests: a
``BENCHMARK.json`` and ``slambench/{configs,traffic,limits,metrics}`` that
the harness finds by name, with every cell at a size the CPU runs in
seconds (16 x 360 sweeps, ``tiny_params``, a 2 s loop age gate)."""

from __future__ import annotations

import dataclasses
import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent   # slambench/
REPO = HERE.parent

SENSOR = {"n_scan": 16, "horizon": 360, "elev_limits_deg": [-15.0, 15.0],
          "scan_dt_s": 0.1, "max_range_m": 80.0, "range_noise_m": 0.01}
DRIVE = {"world": "the simulator's room", "radius_m": 10.0, "speed_m_s": 2.0,
         "height_m": 1.5, "imu_rate_hz": 200.0, "imu_noise_gyr": 1e-3,
         "imu_noise_acc": 1e-2}
TRAFFIC = {
    "replay": {"mode": "replay", "window": 4, "async": True,
               "loop_closure": False, "boot_scans": 8,
               "fast_forward_scans": 0, "drive_scans_per_s": 8,
               "compare_scans": 8, "profile_scans": 8, "workers": 0},
    "live": {"mode": "live", "rate_hz": 10.0, "window": 1,
             "loop_closure": False, "boot_scans": 8,
             "readback_interval": 1000000000, "max_late_s": 60.0,
             "compare_scans": 6, "profile_scans": 6, "workers": 0},
    "loop": {"mode": "replay", "window": 1, "async": False,
             "loop_closure": True, "boot_scans": 8,
             "fast_forward_scans": 16, "warm_loop": True,
             "drive_scans_per_s": 4, "compare_scans": 8, "profile_scans": 4,
             "workers": 0},
}
# each tiny cell is held to the limits of the real cell it stands for
LIMITS_OF = {"replay": "vlp16-replay", "live": "vlp16-live",
             "loop": "vlp16-loop"}


def tiny_params() -> dict:
    from msst_torch.models.liosam.params import tiny_params as tp

    return dataclasses.asdict(tp(history_keyframe_search_time_diff=2.0,
                                 max_points=16 * 360 + 64))


def make_root(dst: Path, cells=("replay", "live", "loop")) -> Path:
    """Write a tiny checkout at `dst`: one configuration ``tiny`` and a
    cell ``tiny-<traffic>`` for each traffic of `cells`, with the real
    manifest's metrics and their readers."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    sb = dst / "slambench"
    for d in ("configs", "traffic", "limits"):
        (sb / d).mkdir(parents=True, exist_ok=True)
    shutil.copytree(HERE / "metrics", sb / "metrics", dirs_exist_ok=True)
    cfg = {"name": "tiny", "sensor": SENSOR, "drive": DRIVE,
           "params": tiny_params()}
    (sb / "configs" / "tiny.json").write_text(json.dumps(cfg))
    names = {"replay": "tiny-replay", "live": "tiny-live",
             "loop": "tiny-loop"}
    work = []
    for tname in cells:
        (sb / "traffic" / f"t_{tname}.json").write_text(
            json.dumps(TRAFFIC[tname]))
        limits = json.loads((HERE / "limits" / f"{LIMITS_OF[tname]}.json")
                            .read_text())
        (sb / "limits" / f"{names[tname]}.json").write_text(
            json.dumps(limits))
        work.append({"name": names[tname], "config": "tiny",
                     "traffic": f"t_{tname}", "chips": 1, "why": "test"})
    # the real metrics, moved onto the tiny cell of the same traffic
    to_tiny = {w["name"]: names.get(w["traffic"]) for w in real["workloads"]}
    present = {w["name"] for w in work}

    def moved(m):
        m = dict(m)
        if "workloads" in m:
            m["workloads"] = sorted({to_tiny.get(w) for w in m["workloads"]}
                                    & present)
        return m

    manifest = dict(real, configs=[{
        "name": "tiny", "source": "test", "file": "slambench/configs/tiny.json",
        "reduced": [], "why": "test"}], workloads=work,
        end_to_end=[moved(m) for m in real["end_to_end"]],
        per_layer=[moved(m) for m in real["per_layer"]])
    (dst / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dst
