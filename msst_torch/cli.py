"""``msst-torch``: the port's command line (commands of msst_tpu's
``msst``, with the same arguments and outputs).

    msst-torch lio-sim [--scans N] [--horizon H] [--loop] [--trace DIR]
    msst-torch lio-kitti DIR [--rings 64] [--horizon 1800] [--scans N] [--loop]
                         [--gps] [--tiny] [--max-points N] [--output F]
                         [--stats-json F] [--viz-every N] [--viz-dir D]
                         [--trace DIR]
    msst-torch lio-bag BAG --cloud-topic T --imu-topic T [--scans N] [--loop]
                       [--tiny] [--sensor auto|velodyne|ouster|livox]
                       [--output F] [--viz-every N] [--viz-dir D]
                       [--trace DIR]
    msst-torch viz-serve [DIR] [--port 8642]
    msst-torch decode-pcap IN.pcap OUT.pcd [--max-packets 100000]
    msst-torch calibrate TARGET.pcd SOURCE.pcd [...] [--method lica|auto|ndt]
                         [--output calibration.json]
    msst-torch allan IMU.csv [--name imu] [--output imu_noise.yaml]
    msst-torch manual-calib TARGET.pcd SOURCE.pcd
    msst-torch heading PCD [PCD ...] [--max-points 16384]
    msst-torch track PCD [PCD ...] [--max-points 1024] [--serve-modbus PORT]
                     [--keep-serving]

``heading`` and ``track`` print one JSON line a frame; frame i is at
0.1 * (i + 1) s and draws from ``torch.Generator(device).manual_seed(i)``.

``lio-kitti`` replays a KITTI raw drive (velodyne .bin sweeps, OXTS IMU and
GNSS) at the HDL-64 profile (64 x 1800, 150,000 points; ``--tiny`` for
msst's small CPU profile), writes the trajectory in the KITTI format and
reports the ATE and the KITTI drift against the OXTS track; ``--gps`` fuses
the OXTS fix as GPS factors once its datum has locked (30 fixes).
``lio-bag`` replays a rosbag 2.0 (PointCloud2 + Imu topics; Velodyne,
Ouster or Livox point layouts).  With ``--viz-every N`` both rewrite
``global_map.ply``, ``trajectory.json`` and ``viewer.html`` in ``--viz-dir``
every N scans (and ``trajectory.png`` where matplotlib is installed), which
``viz-serve`` serves with live reload.  ``--trace DIR`` on the three LIO
commands writes ``DIR/trace.json``, a Chrome trace of the whole run: the
device kernels and the program's spans (``msst/pipeline``, ``msst/step``,
``msst/s2m``, ``msst/gn_iter``, ``msst/keyframe``, ``msst/loop_attempt``,
...; ``msst_torch.utils.profiling``) from every thread on one timeline.  ``decode-pcap`` decodes a pcap of
1206-byte Velodyne-style packets into a PCD with the native decoder
(``msst_torch/native/msst_native.cc``, built with g++ at its first use).

Every command but ``viz-serve`` and ``decode-pcap`` (host only, no
``--device``) runs on the card; ``--device cpu`` runs it on the CPU.  Where
no CUDA device is present and no ``--device cpu`` is given, it raises.
"""

from __future__ import annotations

import argparse
import json
import sys

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


def cmd_lio_sim(args):
    from .models.calibration import device as device_mod
    from .models.liosam import demo

    argv = ["--scans", str(args.scans), "--horizon", str(args.horizon)]
    if args.loop:
        argv.append("--loop")
    if device_mod.resolve(args.device).type == "cpu":
        argv.append("--cpu")
    demo.main(argv)


def _round(x, nd):
    return round(float(x), nd)


def cmd_heading(args):
    from .models.calibration import device as device_mod
    from .models.heading import HeadingConfig, HeadingState, heading_step
    from .utils.io_pcd import read_pcd

    dev = device_mod.resolve(args.device)
    cfg = HeadingConfig(max_points=args.max_points)
    st = HeadingState.create(dev)
    for i, path in enumerate(args.clouds):
        pts, mask = device_mod.pad(read_pcd(path)["xyz"], cfg.max_points, dev)
        st, res = heading_step(st, pts, mask, 0.1 * (i + 1),
                               torch.Generator(device=dev).manual_seed(i), cfg)
        print(json.dumps({
            "frame": i, "roll_deg": _round(res.roll, 3),
            "pitch_deg": _round(res.pitch, 3), "yaw_deg": _round(res.yaw, 3),
            "distances_LF_LB_RF_RB": [_round(x, 3) for x in res.distances],
            "confidence": int(res.confidence),
        }))


def cmd_track(args):
    from .models.calibration import device as device_mod
    from .models.target_tracker import TargetConfig, TrackerState, track_step
    from .utils.io_pcd import read_pcd

    dev = device_mod.resolve(args.device)
    cfg = TargetConfig(max_points=args.max_points)
    st = TrackerState.create(dev)
    srv = None
    if args.serve_modbus:
        from .utils.modbus import ModbusTcpServer

        srv = ModbusTcpServer(host="0.0.0.0", port=args.serve_modbus)
        srv.start()
        print(f"modbus server on :{srv.port}", file=sys.stderr)
    try:
        for i, path in enumerate(args.clouds):
            pcd = read_pcd(path)
            xyz = pcd["xyz"]
            inten = pcd["fields"].get("intensity", np.zeros(len(xyz)))
            pts, mask = device_mod.pad(xyz, cfg.max_points, dev)
            iv = np.zeros(cfg.max_points, np.float32)
            n = min(len(xyz), cfg.max_points)
            iv[:n] = inten[:n]
            st, out = track_step(st, pts, torch.from_numpy(iv).to(dev), mask,
                                 0.1 * (i + 1),
                                 torch.Generator(device=dev).manual_seed(i),
                                 cfg)
            print(json.dumps({
                "frame": i, "valid": bool(out.is_valid),
                "x": _round(out.x, 4), "y": _round(out.y, 4),
                "distance": _round(out.distance, 4),
                "points": int(out.point_count),
                "track": [_round(out.track_x, 4), _round(out.track_y, 4)]}))
            if srv is not None:
                # register map like the reference's bank (node.cpp:151-158)
                srv.set_float(0, float(out.x))
                srv.set_float(2, float(out.y))
                srv.set_float(4, float(out.distance))
                srv.set_registers(6, [int(out.point_count),
                                      int(bool(out.is_valid))])
    finally:
        if srv is not None and not args.keep_serving:
            srv.stop()


GPS_DATUM_SCANS = 30


def _lio_run(scans_iter, params=None, loop=False, gps=False, progress=True,
             viz_every=0, viz_dir=None, device="cuda"):
    """Feed scan dicts through ``LioSam(params, device)``.  viz_every /
    viz_dir: streaming visualization (the live RViz surface of the
    reference: global map @0.2 Hz + path publishers,
    ``mapOptmization.cpp:421-490``): every N scans the current global map
    and trajectory are rewritten under viz_dir.  Like the reference's
    subscriber gate (``utility.h:292`` publishes only when someone
    listens), the export runs only when requested."""
    from .models.liosam import LioSam
    from .models.liosam.params import LioParams

    lio = LioSam(params or LioParams(loop_closure_enabled=loop), device=device)
    n = 0
    degen_flags = []  # per-scan degeneracy flags on the device, read at the end
    # GPS -> odom frame datum (the navsat_transform role,
    # module_navsat.launch:8-19): the fix stream's local frame is anchored at
    # its own (noisy) first fix, so fusing it raw biases every factor by that
    # fix's error.  Wait-for-datum: collect (estimate - fix) over the first
    # GPS scans, while the estimator still tracks confidently, then freeze
    # the mean as the translation datum.  Translation-only: like the
    # reference (useImuHeadingInitialization), the odometry frame's yaw comes
    # from the absolute IMU attitude, so the frames are co-oriented.
    datum_pairs: list = []
    gps_datum = None
    png_skip_said = False
    for s in scans_iter:
        kwargs = {k: s[k] for k in ("imu_t", "imu_gyro", "imu_acc", "imu_rpy")
                  if k in s and s[k] is not None}
        fix = s.get("gps_xyz") if gps else None
        if fix is not None and gps_datum is not None:
            kwargs["gps_xyz"] = (fix + gps_datum).astype(np.float32)
            kwargs["gps_sigma"] = s.get("gps_sigma", np.full(3, 2.0, np.float32))
        out = lio.process_scan(s["xyz"], s["ring"], s["time_rel"],
                               s["scan_start"], **kwargs)
        if fix is not None and gps_datum is None:
            datum_pairs.append(out.pose6[3:6].cpu().numpy() - fix)
            if len(datum_pairs) >= GPS_DATUM_SCANS:
                gps_datum = np.mean(datum_pairs, axis=0)
                print(f"gps datum locked after {len(datum_pairs)} fixes: "
                      f"{np.round(gps_datum, 3)}", file=sys.stderr)
        degen_flags.append(out.degenerate)
        n += 1
        if progress and n % 10 == 0:
            p = out.pose6.cpu().numpy()
            print(f"scan {n}: pos=({p[3]:+.2f},{p[4]:+.2f},{p[5]:+.2f}) "
                  f"kf={int(out.kf_count)}", file=sys.stderr)
        if viz_every and n % viz_every == 0:
            png_skip_said |= _stream_viz(lio, viz_dir or "viz_live", n,
                                         png_skip_said)
    if viz_every and viz_dir:
        _stream_viz(lio, viz_dir, n, png_skip_said)
    # run stats: how often the scan-matching degeneracy projection fired
    # (the reference propagates this flag in odometry covariance[0],
    # mapOptmization.cpp:1696-1699), consumed by --stats-json; the flags
    # come back in one copy
    n_degen = int(torch.stack(degen_flags).sum()) if degen_flags else 0
    lio.last_run_stats = {
        "scans": n,
        "degenerate_scans": n_degen,
        "loops_closed": int(lio.state.n_loop),
    }
    return lio


def _stream_viz(lio, directory, n, png_skip_said=False):
    """One live-visualization tick: overwrite global_map.ply (write then
    rename), trajectory.json and, where matplotlib is installed,
    trajectory.png; viewer.html is written once.  Where matplotlib is
    missing it says so on stderr unless `png_skip_said`; returns whether
    it did."""
    import os

    from .utils import viz, viz_html

    said = False
    os.makedirs(directory, exist_ok=True)
    m = lio.save_map()
    pts = np.concatenate([m["corner_map"], m["surf_map"]]) \
        if len(m["corner_map"]) or len(m["surf_map"]) else np.zeros((0, 3))
    tmp = os.path.join(directory, ".global_map.ply.tmp")
    viz.write_ply(tmp, pts)
    os.replace(tmp, os.path.join(directory, "global_map.ply"))
    est = lio.trajectory.as_matrices()
    if len(est):
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            if not png_skip_said:
                print("viz: matplotlib is not installed; trajectory.png is "
                      "skipped", file=sys.stderr)
                said = True
        else:
            viz.plot_trajectory(os.path.join(directory, "trajectory.png"),
                                est[:, :3, 3])
        viz_html.write_trajectory_json(
            os.path.join(directory, "trajectory.json"), est[:, :3, 3])
    if not os.path.exists(os.path.join(directory, "viewer.html")):
        viz_html.write_viewer(directory)  # `msst-torch viz-serve DIR`
    print(f"viz: scan {n} -> {directory}/global_map.ply "
          f"({len(pts)} pts)", file=sys.stderr)
    return said


def _write_kitti_trajectory(path, traj):
    np.savetxt(path, traj[:, :3, :].reshape(len(traj), 12), fmt="%.6f")


def cmd_lio_kitti(args):
    from .models.calibration import device as device_mod
    from .models.liosam.params import LioParams, tiny_params
    from .utils.io_kitti import KittiRawDrive

    dev = device_mod.resolve(args.device)
    drive = KittiRawDrive(args.dir, n_rings=args.rings)
    it = drive.iter_scans(with_gps=args.gps)
    if args.scans:
        import itertools
        it = itertools.islice(it, args.scans)
    if args.tiny:
        p = tiny_params(n_scan=args.rings, loop_closure_enabled=args.loop,
                        max_points=args.max_points or 32768)
    else:
        p = LioParams(n_scan=args.rings, horizon_scan=args.horizon,
                      max_points=args.max_points or 150000,
                      loop_closure_enabled=args.loop)
    lio = _lio_run(it, params=p, loop=args.loop, gps=args.gps,
                   viz_every=args.viz_every, viz_dir=args.viz_dir, device=dev)
    traj = lio.trajectory.as_matrices()
    _write_kitti_trajectory(args.output, traj)
    print(f"{len(traj)} poses -> {args.output} (KITTI format)")

    # accuracy report against the OXTS ground truth when available
    if drive.oxts is not None and len(traj) >= 2:
        from scipy.spatial.transform import Rotation as Rs

        from .utils import kitti_eval as KE

        enu = drive.gps_enu()
        t_gt, _, _, rpy = drive.imu_samples()
        gt = []
        for k in range(len(traj)):
            ts = drive.velo_times[k]
            i = int(np.clip(np.searchsorted(t_gt, ts), 0, len(enu) - 1))
            T = np.eye(4)
            T[:3, :3] = Rs.from_euler("xyz", rpy[i]).as_matrix()
            T[:3, 3] = enu[i]
            gt.append(T)
        gt = np.stack(gt)
        print(f"ATE RMSE: {KE.ate_rmse(traj, gt) * 100:.1f} cm")
        s = KE.kitti_summary(traj, gt)
        if s["n_segments"]:
            print(f"KITTI drift: {s['t_err_pct']:.2f} % translation, "
                  f"{s['r_err_deg_per_m']:.4f} deg/m rotation "
                  f"({s['n_segments']} segments)")

    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(lio.last_run_stats, f)


def _lio_sensor(sensor: str) -> str:
    """CLI --sensor auto -> the params default (column binning only differs
    for livox, which has no auto signature; explicit flag required there)."""
    return "velodyne" if sensor == "auto" else sensor


def cmd_lio_bag(args):
    from .models.calibration import device as device_mod
    from .models.liosam.params import LioParams, tiny_params
    from .utils.io_rosbag import iter_lio_inputs

    dev = device_mod.resolve(args.device)
    it = iter_lio_inputs(args.bag, args.cloud_topic, args.imu_topic,
                         sensor=args.sensor)
    if args.scans:
        import itertools
        it = itertools.islice(it, args.scans)
    params = None
    if args.tiny:
        params = tiny_params(loop_closure_enabled=args.loop,
                             sensor=_lio_sensor(args.sensor))
    elif args.sensor != "auto":
        params = LioParams(sensor=_lio_sensor(args.sensor))
    lio = _lio_run(it, params=params, loop=args.loop,
                   viz_every=args.viz_every, viz_dir=args.viz_dir, device=dev)
    traj = lio.trajectory.as_matrices()
    _write_kitti_trajectory(args.output, traj)
    print(f"{len(traj)} poses -> {args.output}")


def cmd_viz_serve(args):
    """Interactive map viewer (the reference's RViz surface,
    ``mapOptmization.cpp:421-490,723-774``): serves viewer.html + the
    streamed global_map.ply / trajectory.json, polling for overwrites.
    Host only: no card."""
    from .utils import viz_html

    viz_html.serve(args.dir, port=args.port)


def cmd_decode_pcap(args):
    """Packets to a PCD with the native decoder, on the host: no card."""
    from .utils import native, packets
    from .utils.io_pcd import write_pcd

    pk, stamps = native.read_pcap(args.pcap, args.max_packets)
    if not len(pk):
        sys.exit(f"no 1206-byte packets in {args.pcap}")
    xyz, ring, trel, inten = packets.packets_to_scan(pk, stamps=stamps)
    write_pcd(args.output, xyz, inten)
    print(f"{len(pk)} packets, {len(xyz)} points -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="msst-torch",
        description="msst tools on PyTorch (the card by default)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def parser(name, card=True):
        s = sub.add_parser(name)
        if card:
            s.add_argument("--device", default="cuda",
                           help="torch device: cuda (default) or cpu")
        return s

    def traced(s):
        s.add_argument("--trace", default=None, metavar="DIR",
                       help="write DIR/trace.json: the kernels and the "
                       "program's spans on one timeline")

    s = parser("lio-sim")
    traced(s)
    s.add_argument("--scans", type=int, default=40)
    s.add_argument("--horizon", type=int, default=720)
    s.add_argument("--loop", action="store_true")
    s.set_defaults(fn=cmd_lio_sim)

    s = parser("lio-kitti")
    traced(s)
    s.add_argument("dir")
    s.add_argument("--rings", type=int, default=64)
    s.add_argument("--horizon", type=int, default=1800)
    s.add_argument("--scans", type=int, default=0)
    s.add_argument("--loop", action="store_true")
    s.add_argument("--gps", action="store_true",
                   help="fuse the OXTS GNSS fix as GPS factors (the"
                   " reference's gpsTopic path, mapOptmization.cpp:1397-1475)")
    s.add_argument("--tiny", action="store_true",
                   help="small-capacity params (CPU-friendly)")
    s.add_argument("--output", default="trajectory_kitti.txt")
    s.add_argument("--stats-json", default=None,
                   help="write run stats (degenerate scans, loops) as JSON")
    s.add_argument("--max-points", type=int, default=0,
                   help="input cloud capacity override (0 = profile default)")
    s.add_argument("--viz-every", type=int, default=0,
                   help="write global_map.ply + trajectory.json every N scans")
    s.add_argument("--viz-dir", default="viz_live")
    s.set_defaults(fn=cmd_lio_kitti)

    s = parser("lio-bag")
    traced(s)
    s.add_argument("bag")
    s.add_argument("--cloud-topic", required=True)
    s.add_argument("--imu-topic", required=True)
    s.add_argument("--scans", type=int, default=0)
    s.add_argument("--loop", action="store_true")
    s.add_argument("--tiny", action="store_true",
                   help="small-capacity params (CPU-friendly)")
    s.add_argument("--sensor", default="auto",
                   choices=("auto", "velodyne", "ouster", "livox"),
                   help="vendor point format (the reference's `sensor` "
                        "param, imageProjection.cpp:207-233)")
    s.add_argument("--output", default="trajectory.txt")
    s.add_argument("--viz-every", type=int, default=0,
                   help="write global_map.ply + trajectory.json every N scans")
    s.add_argument("--viz-dir", default="viz_live")
    s.set_defaults(fn=cmd_lio_bag)

    s = parser("viz-serve", card=False)
    s.add_argument("dir", nargs="?", default="viz_live")
    s.add_argument("--port", type=int, default=8642)
    s.set_defaults(fn=cmd_viz_serve)

    s = parser("decode-pcap", card=False)
    s.add_argument("pcap")
    s.add_argument("output")
    s.add_argument("--max-packets", type=int, default=100000)
    s.set_defaults(fn=cmd_decode_pcap)

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

    s = parser("heading")
    s.add_argument("clouds", nargs="+")
    s.add_argument("--max-points", type=int, default=16384)
    s.set_defaults(fn=cmd_heading)

    s = parser("track")
    s.add_argument("clouds", nargs="+")
    s.add_argument("--max-points", type=int, default=1024)
    s.add_argument("--serve-modbus", type=int, default=0)
    s.add_argument("--keep-serving", action="store_true")
    s.set_defaults(fn=cmd_track)

    args = ap.parse_args(argv)
    if getattr(args, "trace", None):
        from .utils import profiling

        with profiling.trace(args.trace):
            args.fn(args)
    else:
        args.fn(args)


if __name__ == "__main__":
    main()
