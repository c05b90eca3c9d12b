"""Minimal PNG writer (stdlib ``zlib`` + ``struct``): 8-bit RGB, no
filtering. The style-transfer task writes its images with it, so the path
needs neither Pillow nor matplotlib."""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def write_png(path: str, rgb: np.ndarray) -> None:
    """rgb: uint8 (H, W, 3)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"write_png expects (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    # one filter-type byte (0 = none) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def float_to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation of x * 255 (matplotlib's
    ``imsave`` rule)."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
