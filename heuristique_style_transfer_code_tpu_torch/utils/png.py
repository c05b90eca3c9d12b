"""Minimal PNG codec (stdlib ``zlib`` + ``struct``) for 8-bit RGB and RGBA:
the style-transfer task writes its images with it (RGBA with an opaque
alpha, as matplotlib's ``imsave`` does) and the style server answers with it
(RGB), so neither path needs Pillow or matplotlib.

``encode_png`` writes no filtering; ``decode_png`` reads 8-bit RGB or RGBA
(colour types 2 and 6), non-interlaced files with any of the five scanline
filters."""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOUR_TYPE = {3: 2, 4: 6}  # channels -> PNG colour type (RGB, RGBA)


def _chunk(tag: bytes, payload: bytes) -> bytes:
    crc = zlib.crc32(tag + payload) & 0xFFFFFFFF
    return struct.pack(">I", len(payload)) + tag + payload + struct.pack(">I", crc)


def encode_png(pixels: np.ndarray) -> bytes:
    """uint8 (H, W, 3) RGB or (H, W, 4) RGBA -> PNG bytes."""
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    if pixels.ndim != 3 or pixels.shape[2] not in _COLOUR_TYPE:
        raise ValueError(f"encode_png expects (H, W, 3|4) uint8, got {pixels.shape}")
    h, w, ch = pixels.shape
    # one filter-type byte (0 = none) in front of every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8), pixels.reshape(h, w * ch)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray) -> None:
    """pixels: uint8 (H, W, 3) RGB or (H, W, 4) RGBA."""
    data = encode_png(pixels)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def _unfilter_pixelwise(kind: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Average (3) and Paeth (4) depend on the pixel to the left as already
    decoded, so they run byte by byte, in place."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            line[i] = (line[i] + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB or RGBA, not interlaced) -> uint8 (H, W, 3) or
    (H, W, 4)."""
    if not data.startswith(_SIGNATURE):
        raise ValueError("not a PNG file")
    pos = len(_SIGNATURE)
    header = None
    idat = []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        payload = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    channels = {t: ch for ch, t in _COLOUR_TYPE.items()}.get(color)
    if depth != 8 or channels is None or interlace != 0:
        raise ValueError(f"decode_png reads 8-bit RGB or RGBA non-interlaced PNGs only "
                         f"(bit depth {depth}, colour type {color}, interlace {interlace})")
    bpp, stride = channels, w * channels
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: running sum along each channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            buf = bytearray(line.tobytes())
            _unfilter_pixelwise(kind, buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG scanline filter {kind} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out.reshape(h, w, channels)


def float_to_uint8(img: np.ndarray) -> np.ndarray:
    """[0, 1] floats -> uint8 by truncation of x * 255 (matplotlib's
    ``imsave`` rule)."""
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
