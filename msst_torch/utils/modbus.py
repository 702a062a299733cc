"""Modbus-TCP client, server and IMU driver (host-side wire adapters; the
port's own copy of ``msst_tpu.utils.modbus``, socket-only).

* :class:`ModbusTcpClient`: the IMU driver's transport
  (``imu_ws/src/imu_modbus_driver/src/imu_modbus_node.cpp``): polls input
  registers, decodes IEEE-754 floats from register pairs
  (``registersToIEEEFloat`` :106-111), with a reconnect loop (:96-104).
* :class:`ModbusTcpServer`: the target tracker's output server
  (``lidar_target02/src/target_detector.cpp:605-1000``): a nonblocking
  select-loop server exposing a register bank, handling function codes 3/4
  (read holding/input registers); ``msst-torch track --serve-modbus``.
* :class:`ImuModbusDriver`: register map + covariances of the reference IMU
  node (:53-59, registers 30..86) producing IMU sample dicts.
"""

from __future__ import annotations

import math
import select
import socket
import struct
import threading
import time
from typing import Optional


def registers_to_float(hi: int, lo: int, word_swap: bool = False) -> float:
    """Two 16-bit registers -> IEEE-754 float (``imu_modbus_node.cpp:106-111``)."""
    if word_swap:
        hi, lo = lo, hi
    return struct.unpack(">f", struct.pack(">HH", hi & 0xFFFF, lo & 0xFFFF))[0]


def float_to_registers(v: float, word_swap: bool = False) -> tuple[int, int]:
    hi, lo = struct.unpack(">HH", struct.pack(">f", v))
    return (lo, hi) if word_swap else (hi, lo)


class ModbusTcpClient:
    def __init__(self, host: str, port: int = 502, unit: int = 1,
                 timeout: float = 1.0):
        self.host, self.port, self.unit = host, port, unit
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._tid = 0

    def connect(self):
        self.close()
        s = socket.create_connection((self.host, self.port), self.timeout)
        s.settimeout(self.timeout)
        self.sock = s

    def close(self):
        if self.sock:
            try:
                self.sock.close()
            finally:
                self.sock = None

    def ensure_connected(self, retries: int = 3, delay: float = 0.5):
        """Reconnect loop (:96-104)."""
        for _ in range(retries):
            try:
                if self.sock is None:
                    self.connect()
                return True
            except OSError:
                self.close()
                time.sleep(delay)
        return False

    def read_registers(self, start: int, count: int, func: int = 4) -> list[int]:
        """func 4 = input registers, 3 = holding registers."""
        if self.sock is None:
            raise ConnectionError("not connected")
        self._tid = (self._tid + 1) & 0xFFFF
        req = struct.pack(">HHHBBHH", self._tid, 0, 6, self.unit, func, start, count)
        self.sock.sendall(req)
        hdr = self._recv_exact(9)
        tid, proto, length, unit, fc = struct.unpack(">HHHBB", hdr[:8])
        if fc & 0x80:
            raise IOError(f"modbus exception {hdr[8]}")
        nbytes = hdr[8]
        data = self._recv_exact(nbytes)
        return list(struct.unpack(f">{count}H", data))

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self.sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("peer closed")
            out += chunk
        return out


class ModbusTcpServer:
    """Register bank served over Modbus-TCP (function codes 3 and 4).
    Thread-safe writes via :meth:`set_registers` — the tracker updates the
    bank from the estimation loop (atomic bank, ``node.cpp:151-158``)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 1502, n_regs: int = 128):
        self.addr = (host, port)
        self.regs = [0] * n_regs
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.port = None

    def set_registers(self, start: int, values: list[int]):
        with self._lock:
            for i, v in enumerate(values):
                self.regs[start + i] = v & 0xFFFF

    def set_float(self, start: int, value: float):
        self.set_registers(start, list(float_to_registers(value)))

    def start(self):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind(self.addr)
        srv.listen(4)
        srv.setblocking(False)
        self.port = srv.getsockname()[1]
        self._srv = srv
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        self._srv.close()

    def _loop(self):
        clients: dict[socket.socket, bytes] = {}
        while not self._stop.is_set():
            rl = [self._srv] + list(clients)
            ready, _, _ = select.select(rl, [], [], 0.1)
            for s in ready:
                if s is self._srv:
                    try:
                        c, _ = self._srv.accept()
                        c.setblocking(False)
                        clients[c] = b""
                    except OSError:
                        pass
                    continue
                try:
                    data = s.recv(4096)
                except OSError:
                    data = b""
                if not data:
                    s.close()
                    clients.pop(s, None)
                    continue
                clients[s] += data
                clients[s] = self._handle(s, clients[s])

    def _handle(self, sock, buf: bytes) -> bytes:
        while len(buf) >= 8:
            tid, proto, length = struct.unpack(">HHH", buf[:6])
            if len(buf) < 6 + length:
                break
            pdu = buf[6:6 + length]
            buf = buf[6 + length:]
            unit, fc = pdu[0], pdu[1]
            if fc in (3, 4) and len(pdu) >= 6:
                start, count = struct.unpack(">HH", pdu[2:6])
                with self._lock:
                    vals = self.regs[start:start + count]
                body = struct.pack(f">B{len(vals)}H", len(vals) * 2, *vals)
                resp = struct.pack(">HHHBB", tid, 0, 2 + len(body), unit, fc) + body
            else:
                resp = struct.pack(">HHHBBB", tid, 0, 3, unit, fc | 0x80, 1)
            try:
                sock.sendall(resp)
            except OSError:
                pass
        return buf


class ImuModbusDriver:
    """The IMU polling node: registers 30..86 at 192.168.188.105:502 decode to
    rpy / gyro / acc floats; covariances hardcoded from a prior Allan run
    (:53-59)."""

    REG_START = 30
    REG_COUNT = 36  # 18 floats

    ORIENTATION_COV = [1e-4, 0, 0, 0, 1e-4, 0, 0, 0, 1e-4]
    GYRO_COV = [2.5e-5, 0, 0, 0, 2.5e-5, 0, 0, 0, 2.5e-5]
    ACC_COV = [1e-4, 0, 0, 0, 1e-4, 0, 0, 0, 1e-4]

    def __init__(self, host: str = "192.168.188.105", port: int = 502,
                 extrinsics=None):
        """extrinsics: optional :class:`~msst_torch.utils.imu_adapter.
        ImuExtrinsics` applied to every polled sample (the reference's
        ``imuConverter``, ``utility.h:252-282``)."""
        self.client = ModbusTcpClient(host, port)
        self.extrinsics = extrinsics

    def poll(self) -> Optional[dict]:
        if not self.client.ensure_connected():
            return None
        try:
            regs = self.client.read_registers(self.REG_START, self.REG_COUNT)
        except (OSError, IOError):
            self.client.close()
            return None
        floats = [registers_to_float(regs[2 * i], regs[2 * i + 1])
                  for i in range(len(regs) // 2)]
        # layout: rpy[3], gyro[3], acc[3] (remaining floats reserved)
        if not all(math.isfinite(f) for f in floats[:9]):
            return None  # validity gating (:121-133)
        rpy, gyro, acc = floats[0:3], floats[3:6], floats[6:9]
        if self.extrinsics is not None and not self.extrinsics.is_identity():
            from .imu_adapter import convert_imu
            gyro, acc, rpy = convert_imu(self.extrinsics, gyro, acc, rpy=rpy)
            rpy, gyro, acc = list(rpy), list(gyro), list(acc)
        return {
            "rpy": rpy,
            "gyro": gyro,
            "acc": acc,
            "orientation_covariance": self.ORIENTATION_COV,
            "angular_velocity_covariance": self.GYRO_COV,
            "linear_acceleration_covariance": self.ACC_COV,
        }
