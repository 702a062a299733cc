"""GPS timestamp conversion for LiDAR packets.

Rebuild of the driver's ``time_conversion.hpp`` (184 LoC,
``timoo/src/timoo_driver/src/driver/``): Velodyne-class packets carry a
4-byte timestamp of microseconds past the top of the hour (GPS-synchronized);
resolve it against the receive time to a full unix stamp, handling the
hour-rollover races on both sides.

The port's own copy of ``msst_tpu.utils.gpstime``, held equal to it by
tests/test_torch_io_adapters.py (the port imports nothing of msst_tpu).
"""

from __future__ import annotations

HOUR_US = 3600 * 1_000_000


def resolve_hour_timestamp(packet_us: int, recv_unix: float) -> float:
    """Packet microseconds-past-the-hour + host receive time -> unix seconds.

    Picks the hour boundary (previous/current/next) that puts the packet
    stamp closest to the receive time — the same rollover handling as the
    reference helper."""
    recv_us = int(recv_unix * 1e6)
    hour_start = recv_us - (recv_us % HOUR_US)
    candidates = [
        hour_start - HOUR_US + packet_us,
        hour_start + packet_us,
        hour_start + HOUR_US + packet_us,
    ]
    best = min(candidates, key=lambda c: abs(c - recv_us))
    return best / 1e6


def packet_timestamp_us(packet: bytes) -> int:
    """Extract the 4-byte little-endian timestamp at offset 1200 of a
    1206-byte packet."""
    return int.from_bytes(packet[1200:1204], "little")
