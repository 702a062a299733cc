"""``msst-torch``: the port's command line (the calibration commands of
msst_tpu's ``msst``, with the same arguments and outputs).

    msst-torch calibrate TARGET.pcd SOURCE.pcd [...] [--method lica|auto|ndt]
                         [--output calibration.json]
    msst-torch allan IMU.csv [--name imu] [--output imu_noise.yaml]
    msst-torch manual-calib TARGET.pcd SOURCE.pcd

Every command runs on the card; ``--device cpu`` runs it on the CPU.  Where
no CUDA device is present and no ``--device cpu`` is given, it raises.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

# msst_tpu's CLI pads each auto-calibration cloud to this many points
AUTO_CAPACITY = 32768


def _matrix(pose) -> list:
    return pose.to_matrix().detach().cpu().numpy().tolist()


def cmd_calibrate(args):
    from .models.calibration import device as device_mod
    from .utils.io_pcd import read_pcd

    dev = device_mod.resolve(args.device)
    tgt = read_pcd(args.target)["xyz"]
    srcs = [read_pcd(p)["xyz"] for p in args.sources]
    results = {}
    if args.method == "lica":
        from .models.calibration.multi_lica import (MultiLicaConfig,
                                                    MultiLidarCalibrator)

        cal = MultiLidarCalibrator(MultiLicaConfig(), device=dev)
        for i, r in enumerate(cal.standard_calibration(tgt, srcs)):
            results[f"source_{i}"] = {
                "matrix": _matrix(r.pose),
                "fitness": float(r.fitness), "rmse": float(r.rmse),
            }
    elif args.method == "auto":
        from .models.calibration.auto_calib import (AutoCalibConfig,
                                                    auto_calibrate)

        cfg = AutoCalibConfig()
        m_x, m_m = device_mod.pad(tgt, AUTO_CAPACITY, dev)
        for i, s in enumerate(srcs):
            s_x, s_m = device_mod.pad(s, AUTO_CAPACITY, dev)
            r = auto_calibrate(m_x, m_m, s_x, s_m, cfg,
                               torch.Generator(device=dev).manual_seed(i))
            results[f"source_{i}"] = {
                "matrix": _matrix(r.pose),
                "fitness": float(r.icp_rmse),
            }
    else:  # ndt
        from .models.calibration.ndt_calib import NdtCalibrator

        for i, s in enumerate(srcs):
            cal = NdtCalibrator(device=dev)
            cal.process_pair(tgt, s)
            results[f"source_{i}"] = {
                "matrix": _matrix(cal.pose),
                "score": cal.history[-1],
                "tf_command": cal.static_transform_command(),
            }
    with open(args.output, "w") as f:
        json.dump(results, f, indent=2)
    print(f"calibration -> {args.output}")


def cmd_manual_calib(args):  # pragma: no cover - interactive
    from .models.calibration.manual_calib import ManualCalibrator
    from .utils.io_pcd import read_pcd

    cal = ManualCalibrator(read_pcd(args.source)["xyz"],
                           read_pcd(args.target)["xyz"], device=args.device)
    cal.run_interactive()


def cmd_allan(args):
    from .models.calibration.imu_allan import AllanCalibrator

    data = np.loadtxt(args.csv, delimiter=",")  # t, gx, gy, gz, ax, ay, az
    cal = AllanCalibrator(name=args.name, device=args.device)
    for row in data:
        cal.add_sample(row[0], row[1:4], row[4:7])
    res = cal.write_yaml(args.output)
    print(json.dumps({k: res[k] for k in
                      ("gyr_n", "gyr_w", "acc_n", "acc_w", "duration_min")},
                     indent=2))
    print(f"noise YAML -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="msst-torch",
        description="msst calibration tools on PyTorch (the card by default)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def parser(name):
        s = sub.add_parser(name)
        s.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu")
        return s

    s = parser("calibrate")
    s.add_argument("target")
    s.add_argument("sources", nargs="+")
    s.add_argument("--method", choices=["lica", "auto", "ndt"], default="lica")
    s.add_argument("--output", default="calibration.json")
    s.set_defaults(fn=cmd_calibrate)

    s = parser("manual-calib")
    s.add_argument("target")
    s.add_argument("source")
    s.set_defaults(fn=cmd_manual_calib)

    s = parser("allan")
    s.add_argument("csv")
    s.add_argument("--name", default="imu")
    s.add_argument("--output", default="imu_noise.yaml")
    s.set_defaults(fn=cmd_allan)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
