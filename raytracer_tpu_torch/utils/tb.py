"""Minimal TensorBoard event writing: scalar summaries only.

The port's own copy of ``raytracer_tpu/utils/tb.py``, standard library
only.  The reference trains SB3 PPO with ``tensorboard_log=...``
(RL/train_raytracer.py:143); the FB trainers (``fb/trainer.py``) write the
same artifact family when ``tensorboard_log`` is set.  The tfevents record
frame (length | masked-crc32c | payload | masked-crc32c) and the two
protobuf messages (Event, Summary.Value with ``simple_value``) are
hand-encoded, so event writing needs neither tensorflow nor tensorboardX.
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

# -- crc32c (Castagnoli, reflected poly 0x82F63B78), table-driven ---------
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# -- protobuf wire helpers --------------------------------------------------
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _field_double(num: int, v: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", v)


def _field_float(num: int, v: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", v)


def _field_varint(num: int, v: int) -> bytes:
    return _varint(num << 3) + _varint(v)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def _event(wall_time: float, *, step: int = 0,
           file_version: Optional[str] = None,
           tag: Optional[str] = None,
           value: Optional[float] = None) -> bytes:
    ev = _field_double(1, wall_time)                     # Event.wall_time
    if file_version is not None:
        ev += _field_bytes(3, file_version.encode())     # Event.file_version
    if tag is not None:
        sv = (_field_bytes(1, tag.encode())              # Value.tag
              + _field_float(2, float(value)))           # Value.simple_value
        ev += _field_varint(2, step)                     # Event.step
        ev += _field_bytes(5, _field_bytes(1, sv))       # Event.summary.value
    return ev


class SummaryWriter:
    """Append-only scalar event writer, SB3-compatible directory layout:
    ``SummaryWriter(logdir)`` creates ``logdir/events.out.tfevents.*`` and
    ``add_scalar("rollout/ep_rew_mean", v, step)`` mirrors SB3's tags."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname() or "host"
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}")
        self._f = open(self.path, "ab")
        self._write(_event(time.time(), file_version="brain.Event:2"))

    def _write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header + struct.pack("<I", _masked_crc(header))
                      + payload + struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step=int(step), tag=tag,
                           value=float(value)))

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def next_run_dir(base: str, prefix: str) -> str:
    """SB3's run-directory convention: ``{base}/{prefix}_{N}`` with N the
    first unused integer (RL/train_raytracer.py writes PPO_1, PPO_2, ...)."""
    n = 1
    while os.path.exists(os.path.join(base, f"{prefix}_{n}")):
        n += 1
    return os.path.join(base, f"{prefix}_{n}")
