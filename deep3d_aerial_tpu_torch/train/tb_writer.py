"""TensorBoard-compatible event writer, dependency-free (a copy of the JAX
package's train/tb_writer.py, comments aside; its event bytes are the same).

The reference logs training scalars and image grids through tensorboardX
(its utils.py:117-147, hooked at train_whu.py:174-178). This module writes
genuine TensorBoard event files (TFRecord-framed Event protos with masked
CRC32C) using nothing but the stdlib + PIL for PNG encoding, plus a JSONL
mirror that is grep/plot-friendly without TB.

Proto field numbers (stable public TF wire format):
  Event:        wall_time=1 (double), step=2 (int64), summary=5 (message)
  Summary:      value=1 (repeated message)
  Summary.Value: tag=1 (string), simple_value=2 (float), image=4 (message)
  Summary.Image: height=1, width=2, colorspace=3 (varint),
                 encoded_image_string=4 (bytes)
"""

from __future__ import annotations

import io
import json
import os
import socket
import struct
import time
from typing import Dict, Optional

import numpy as np

# ---------------------------------------------------------------- crc32c
_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if _CRC_TABLE:
        return _CRC_TABLE
    poly = 0x82F63B78  # Castagnoli, reflected
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    _CRC_TABLE = table
    return table


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------ protobuf
def _varint(n: int) -> bytes:
    out = b""
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out += bytes([b | 0x80])
        else:
            out += bytes([b])
            return out


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _f_double(num: int, v: float) -> bytes:
    return _field(num, 1) + struct.pack("<d", v)


def _f_float(num: int, v: float) -> bytes:
    return _field(num, 5) + struct.pack("<f", v)


def _f_varint(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _f_bytes(num: int, v: bytes) -> bytes:
    return _field(num, 2) + _varint(len(v)) + v


def _summary_scalar(tag: str, value: float) -> bytes:
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    return _f_bytes(1, val)  # Summary.value


def _summary_image(tag: str, png: bytes, h: int, w: int, ch: int) -> bytes:
    img = (_f_varint(1, h) + _f_varint(2, w) + _f_varint(3, ch)
           + _f_bytes(4, png))
    val = _f_bytes(1, tag.encode()) + _f_bytes(4, img)
    return _f_bytes(1, val)


def _event(step: int, summary_fields: bytes) -> bytes:
    return (_f_double(1, time.time()) + _f_varint(2, step)
            + _f_bytes(5, summary_fields))


# -------------------------------------------------------------- writer
class EventWriter:
    """Writes TensorBoard event files + a JSONL scalar mirror."""

    def __init__(self, logdir: str, jsonl: bool = True):
        os.makedirs(logdir, exist_ok=True)
        fname = (
            f"events.out.tfevents.{int(time.time())}."
            f"{socket.gethostname()}"
        )
        self._f = open(os.path.join(logdir, fname), "ab")
        self._jsonl = (
            open(os.path.join(logdir, "scalars.jsonl"), "a") if jsonl else None
        )
        self._write_record(_event(0, b""))  # TB expects a first event

    def _write_record(self, data: bytes):
        hdr = struct.pack("<Q", len(data))
        self._f.write(hdr)
        self._f.write(struct.pack("<I", _masked_crc(hdr)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))
        self._f.flush()

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_event(step, _summary_scalar(tag, value)))
        if self._jsonl:
            self._jsonl.write(json.dumps(
                {"step": int(step), "tag": tag, "value": float(value),
                 "t": time.time()}) + "\n")
            self._jsonl.flush()

    def add_image(self, tag: str, img: np.ndarray, step: int):
        """img: [H, W] float (viridis-free grayscale) or [H, W, 3] uint8."""
        from PIL import Image

        arr = np.asarray(img)
        if arr.ndim == 2:
            lo, hi = np.nanmin(arr), np.nanmax(arr)
            arr = ((arr - lo) / (hi - lo + 1e-12) * 255).astype(np.uint8)
            arr = np.dstack([arr] * 3)
        if arr.dtype != np.uint8:
            arr = np.clip(arr * 255, 0, 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="PNG")
        png = buf.getvalue()
        h, w = arr.shape[:2]
        self._write_record(
            _event(step, _summary_image(tag, png, h, w, arr.shape[2]))
        )

    def close(self):
        self._f.close()
        if self._jsonl:
            self._jsonl.close()


def save_scalars(writer: Optional[EventWriter], mode: str,
                 scalars: Dict[str, float], step: int):
    """Reference save_scalars semantics (utils.py:117-127): tags
    '<mode>/<name>'; dict values may be lists (indexed tags)."""
    if writer is None:
        return
    for name, value in scalars.items():
        if isinstance(value, (list, tuple)):
            for i, v in enumerate(value):
                writer.add_scalar(f"{mode}/{name}_{i}", float(v), step)
        else:
            writer.add_scalar(f"{mode}/{name}", float(value), step)


def save_images(writer: Optional[EventWriter], mode: str,
                images: Dict[str, np.ndarray], step: int):
    """Reference save_images semantics (utils.py:129-147): '<mode>/<name>'
    image summaries; accepts [H, W] / [H, W, C] arrays."""
    if writer is None:
        return
    for name, img in images.items():
        writer.add_image(f"{mode}/{name}", np.asarray(img), step)
