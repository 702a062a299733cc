"""Minimal pure-Python rosbag v2.0 reader.

The reference validates everything by replaying recorded rosbags
(``liosam_ws/src/LIO-SAM/README.md:129-146``); this reader lets the
pipeline consume those same bags without ROS.  Supports the bag 2.0 format
(record structure per the public spec): uncompressed and bz2 chunks, and
decodes the two message types the pipeline needs — ``sensor_msgs/PointCloud2``
and ``sensor_msgs/Imu`` (plus ``nav_msgs/Odometry`` for GPS pipelines).

The port's own copy of ``msst_tpu.utils.io_rosbag``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

import bz2
import struct
from typing import Iterator

import numpy as np

_POINTFIELD_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}


def _read_header(data: bytes) -> dict:
    """Parse a rosbag record header: sequence of len-prefixed name=value."""
    fields = {}
    o = 0
    while o < len(data):
        (flen,) = struct.unpack_from("<I", data, o)
        o += 4
        entry = data[o:o + flen]
        o += flen
        eq = entry.index(b"=")
        fields[entry[:eq].decode()] = entry[eq + 1:]
    return fields


def _records(buf: bytes) -> Iterator[tuple[dict, bytes]]:
    o = 0
    n = len(buf)
    while o + 8 <= n:
        (hlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        header = _read_header(buf[o:o + hlen])
        o += hlen
        (dlen,) = struct.unpack_from("<I", buf, o)
        o += 4
        data = buf[o:o + dlen]
        o += dlen
        yield header, data


class RosbagReader:
    """Iterates (topic, stamp_sec, connection_info, raw_message_bytes)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            magic = f.readline()
            if not magic.startswith(b"#ROSBAG V2.0"):
                raise ValueError(f"not a rosbag 2.0 file: {magic!r}")
            self._buf = f.read()
        self.connections: dict[int, dict] = {}

    def messages(self, topics=None) -> Iterator[tuple[str, float, dict, bytes]]:
        for header, data in _records(self._buf):
            op = header.get("op", b"")[0] if header.get("op") else None
            if op == 7:  # connection
                conn = int.from_bytes(header["conn"], "little")
                info = _read_header(data)
                self.connections[conn] = {
                    "topic": header["topic"].decode(),
                    "type": info.get("type", b"").decode(),
                    "md5sum": info.get("md5sum", b"").decode(),
                }
            elif op == 5:  # chunk
                compression = header.get("compression", b"none").decode()
                chunk = data
                if compression == "bz2":
                    chunk = bz2.decompress(data)
                elif compression not in ("none",):
                    raise ValueError(f"unsupported compression {compression}")
                yield from self._chunk_messages(chunk, topics)

    def _chunk_messages(self, chunk: bytes, topics):
        for header, data in _records(chunk):
            op = header.get("op", b"")[0] if header.get("op") else None
            if op == 7:
                conn = int.from_bytes(header["conn"], "little")
                info = _read_header(data)
                self.connections[conn] = {
                    "topic": header["topic"].decode(),
                    "type": info.get("type", b"").decode(),
                    "md5sum": info.get("md5sum", b"").decode(),
                }
            elif op == 2:  # message data
                conn = int.from_bytes(header["conn"], "little")
                sec, nsec = struct.unpack("<II", header["time"])
                info = self.connections.get(conn, {})
                topic = info.get("topic", "")
                if topics and topic not in topics:
                    continue
                yield topic, sec + nsec * 1e-9, info, data


# ---------------------------------------------------------------------------
# message decoders (ROS1 serialization)
# ---------------------------------------------------------------------------


def _read_string(buf, o):
    (n,) = struct.unpack_from("<I", buf, o)
    return buf[o + 4:o + 4 + n].decode(), o + 4 + n


def decode_pointcloud2(buf: bytes) -> dict:
    o = 0
    (seq,) = struct.unpack_from("<I", buf, o); o += 4
    sec, nsec = struct.unpack_from("<II", buf, o); o += 8
    frame, o = _read_string(buf, o)
    height, width = struct.unpack_from("<II", buf, o); o += 8
    (nfields,) = struct.unpack_from("<I", buf, o); o += 4
    fields = []
    for _ in range(nfields):
        name, o = _read_string(buf, o)
        off, dt, cnt = struct.unpack_from("<IBI", buf, o); o += 9
        fields.append((name, off, dt, cnt))
    bigendian = buf[o]; o += 1
    point_step, row_step = struct.unpack_from("<II", buf, o); o += 8
    (dlen,) = struct.unpack_from("<I", buf, o); o += 4
    data = np.frombuffer(buf, np.uint8, count=dlen, offset=o)
    o += dlen
    is_dense = buf[o] if o < len(buf) else 1

    n = height * width
    raw = data[: n * point_step].reshape(n, point_step)
    out = {"stamp": sec + nsec * 1e-9, "frame_id": frame, "height": height,
           "width": width, "is_dense": bool(is_dense)}
    for name, off, dt, cnt in fields:
        base = _POINTFIELD_DTYPES[dt]
        nb = np.dtype(base).itemsize
        col = raw[:, off:off + nb * cnt].copy().view(base)
        out[name] = col.reshape(n) if cnt == 1 else col.reshape(n, cnt)
    return out


def decode_imu(buf: bytes) -> dict:
    o = 0
    o += 4  # seq
    sec, nsec = struct.unpack_from("<II", buf, o); o += 8
    frame, o = _read_string(buf, o)
    qx, qy, qz, qw = struct.unpack_from("<4d", buf, o); o += 32
    o += 72  # orientation covariance
    wx, wy, wz = struct.unpack_from("<3d", buf, o); o += 24
    o += 72
    ax, ay, az = struct.unpack_from("<3d", buf, o); o += 24
    return {
        "stamp": sec + nsec * 1e-9, "frame_id": frame,
        "orientation": np.array([qw, qx, qy, qz]),
        "angular_velocity": np.array([wx, wy, wz]),
        "linear_acceleration": np.array([ax, ay, az]),
    }


def decode_odometry(buf: bytes) -> dict:
    o = 0
    o += 4
    sec, nsec = struct.unpack_from("<II", buf, o); o += 8
    frame, o = _read_string(buf, o)
    child, o = _read_string(buf, o)
    px, py, pz = struct.unpack_from("<3d", buf, o); o += 24
    qx, qy, qz, qw = struct.unpack_from("<4d", buf, o); o += 32
    cov = np.frombuffer(buf, np.float64, 36, o); o += 36 * 8
    return {"stamp": sec + nsec * 1e-9, "frame_id": frame, "child_frame_id": child,
            "position": np.array([px, py, pz]),
            "orientation": np.array([qw, qx, qy, qz]),
            "pose_covariance": cov.reshape(6, 6)}


def iter_lio_inputs(path: str, cloud_topic: str, imu_topic: str,
                    imu_extrinsics=None, sensor: str = "auto"):
    """Replay a bag into per-scan dicts shaped for LioSam.process_scan.

    imu_extrinsics: optional :class:`~msst_torch.utils.imu_adapter.ImuExtrinsics`
    applied to every IMU sample before windowing (the reference converts in
    each IMU callback, ``utility.h:252-282``).

    sensor: "velodyne" | "ouster" | "livox" | "auto" — the reference's
    ``sensor`` param (``imageProjection.cpp:207-233``); selects the vendor
    point-format conversion (Ouster ships uint32-nanosecond point times).
    "auto" detects Ouster from its signature fields."""
    from .imu_adapter import ImuExtrinsics, convert_scan_dict
    from .sensor_formats import ScanStreamChecker
    if imu_extrinsics is None:
        imu_extrinsics = ImuExtrinsics.identity()
    reader = RosbagReader(path)
    checker = ScanStreamChecker(sensor)
    imu_t, imu_g, imu_a, imu_q = [], [], [], []
    for topic, stamp, info, raw in reader.messages({cloud_topic, imu_topic}):
        if topic == imu_topic:
            m = decode_imu(raw)
            imu_t.append(m["stamp"])
            imu_g.append(m["angular_velocity"])
            imu_a.append(m["linear_acceleration"])
            imu_q.append(m["orientation"])
        else:
            m = decode_pointcloud2(raw)
            conv = checker.convert(m)
            xyz, ring, trel = conv["xyz"], conv["ring"], conv["time_rel"]
            t_arr = np.asarray(imu_t)
            sel = (t_arr >= m["stamp"] - 0.5) & (t_arr <= m["stamp"] + 0.2) \
                if len(t_arr) else np.zeros(0, bool)
            from scipy.spatial.transform import Rotation as Rs
            rpy = np.zeros(3, np.float32)
            if sel.any():
                q = np.asarray(imu_q)[sel][-1]
                rpy = Rs.from_quat([q[1], q[2], q[3], q[0]]).as_euler("xyz").astype(np.float32)
            yield convert_scan_dict(imu_extrinsics, dict(
                xyz=xyz, ring=ring, time_rel=trel, scan_start=m["stamp"],
                intensity=conv["intensity"],
                imu_t=t_arr[sel] if sel.any() else np.zeros(0, np.float64),
                imu_gyro=np.asarray(imu_g)[sel].astype(np.float32) if sel.any() else np.zeros((0, 3), np.float32),
                imu_acc=np.asarray(imu_a)[sel].astype(np.float32) if sel.any() else np.zeros((0, 3), np.float32),
                imu_rpy=rpy,
            ))
