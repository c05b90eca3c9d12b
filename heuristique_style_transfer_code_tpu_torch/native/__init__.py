"""The native (C++) JPEG decoder of the host loader (``native/__init__.py``
of the JAX package, ported; ``decoder.cpp`` is a copy of its source).

``decoder.cpp`` decodes a JPEG with libjpeg, resamples it with a
reimplementation of Pillow's fixed-point BILINEAR and center-crops it:
the staged canvas of ``data/loader.decode_image_staged_bytes``, bit for bit
the PIL path's. It is compiled with ``g++ -O2 -fPIC -shared -std=c++17 ...
-ljpeg`` at first use (never at import) into ``_build/`` of this package
(or, where that is not writable, a cache directory named for the port) and
called through ``ctypes``, which releases the GIL, so the loader's decode
threads run in parallel. Host-only: no accelerator is involved.

``HST_NATIVE_DECODE``: ``0`` off, ``1`` required (a build failure raises),
unset auto (a build failure falls back to PIL, once for the process).
``HST_NATIVE_DECODE_FAST=1`` opts in to decoding at a coarser libjpeg DCT
scale where the canvas allows it: faster, not bit-identical.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from ..core.geometry import staging_geometry

_ABI = 3  # hst_abi_version() in decoder.cpp
_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "decoder.cpp")
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_lock = threading.Lock()
_decoder: Optional["NativeJpegDecoder"] = None
_failed: Optional[str] = None


def _build_dirs():
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.expanduser("~/.cache")
    return [os.path.join(_PKG, "_build"),
            os.path.join(cache, "heuristique_style_transfer_code_tpu_torch")]


def _compile() -> str:
    """``decoder.cpp`` compiled into a shared library (kept while the
    source's mtime matches its stamp); returns its path."""
    src_mtime = os.stat(_SRC).st_mtime_ns
    name = f"libhstdec_abi{_ABI}.so"
    last_err = None
    for d in _build_dirs():
        so = os.path.join(d, name)
        stamp = so + ".src_mtime"
        try:
            if os.path.exists(so) and os.path.exists(stamp):
                with open(stamp) as f:
                    if f.read().strip() == str(src_mtime):
                        return so
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=d)
            os.close(fd)
            try:
                cmd = ["g++", "-O2", "-fPIC", "-shared", "-std=c++17", "-o", tmp, _SRC,
                       "-ljpeg"]
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
                if proc.returncode != 0:
                    raise RuntimeError(f"g++ failed: {proc.stderr.strip()[:500]}")
                os.replace(tmp, so)  # atomic: concurrent builds race benignly
            except BaseException:
                if os.path.exists(tmp):  # a timeout too: never leave the temp file
                    os.unlink(tmp)
                raise
            sfd, stmp = tempfile.mkstemp(suffix=".stamp", dir=d)
            with os.fdopen(sfd, "w") as f:
                f.write(str(src_mtime))
            os.replace(stmp, stamp)
            return so
        except Exception as e:  # the next candidate directory
            last_err = e
    raise RuntimeError(f"native decoder build failed: {last_err}")


class NativeJpegDecoder:
    """The ``ctypes`` binding of ``decoder.cpp`` (no shared state in C:
    thread-safe)."""

    def __init__(self, so_path: str):
        lib = ctypes.CDLL(so_path)
        lib.hst_jpeg_dims.restype = ctypes.c_int
        lib.hst_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.c_ulong,
                                      ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.hst_decode_resize_crop.restype = ctypes.c_int
        lib.hst_decode_resize_crop.argtypes = [
            ctypes.c_char_p, ctypes.c_ulong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.hst_abi_version.restype = ctypes.c_int
        if lib.hst_abi_version() != _ABI:
            raise RuntimeError("native decoder ABI mismatch")
        self._lib = lib
        self.so_path = so_path

    def jpeg_dims(self, data: bytes) -> Optional[Tuple[int, int]]:
        w, h = ctypes.c_int(), ctypes.c_int()
        if self._lib.hst_jpeg_dims(data, len(data), ctypes.byref(w), ctypes.byref(h)) != 0:
            return None
        return w.value, h.value

    def decode_staged(self, data: bytes, staging: int = 256,
                      fast: bool = False) -> Optional[np.ndarray]:
        """JPEG bytes -> (staging, staging, 3) uint8, the PIL path's pixels;
        None where the caller must take PIL (a corrupt file, CMYK, ...).
        ``fast`` decodes at the coarsest 1/2^k DCT scale whose shorter side
        still covers ``staging``, then resamples: not bit-identical."""
        dims = self.jpeg_dims(data)
        if dims is None:
            return None
        w, h = dims
        if w <= 0 or h <= 0:
            return None
        tw, th, left, top = staging_geometry(w, h, staging)
        ch, cw = min(staging, th), min(staging, tw)
        denom = 1
        if fast:
            while denom < 8 and min(-(-h // (denom * 2)), -(-w // (denom * 2))) >= staging:
                denom *= 2
        out = np.empty((ch, cw, 3), dtype=np.uint8)
        rc = self._lib.hst_decode_resize_crop(data, len(data), tw, th, left, top, cw, ch, denom,
                                              out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0 or (ch, cw) != (staging, staging):
            return None
        return out


def get_decoder() -> Optional[NativeJpegDecoder]:
    """The native decoder, built once, or None where it is off or (auto)
    its build failed. ``HST_NATIVE_DECODE``: ``0`` off, ``1`` required,
    unset auto."""
    global _decoder, _failed
    mode = os.environ.get("HST_NATIVE_DECODE", "").strip()
    if mode == "0":
        return None
    with _lock:
        if _decoder is not None:
            return _decoder
        if _failed is not None and mode != "1":
            return None
        try:
            _decoder = NativeJpegDecoder(_compile())
            return _decoder
        except Exception as e:
            _failed = str(e)
            if mode == "1":
                raise
            return None


def is_jpeg(data: bytes) -> bool:
    return len(data) > 3 and data[:2] == b"\xff\xd8"
