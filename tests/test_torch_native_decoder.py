"""The port's native JPEG decoder (``native/``, a copy of the JAX package's
``decoder.cpp`` with the port's ``ctypes`` binding) and the staged decode
that takes it first (``data/loader.decode_image_staged_bytes``), on the
CPU: bit-equal to the port's PIL path and to the JAX package's native
decoder on JPEGs of several sizes, qualities and chroma subsamplings;
``HST_NATIVE_DECODE`` 0 (off), 1 (required: a build failure raises) and
unset (auto: a build failure falls back to PIL); the fast path
(``HST_NATIVE_DECODE_FAST=1``) close to the exact one; the build lands in
the port's ``_build/``."""
import io
import os

import numpy as np
import pytest
from PIL import Image

from heuristique_style_transfer_code_tpu_torch import native
from heuristique_style_transfer_code_tpu_torch.data import loader

SHAPES = [(640, 480, 90, 2), (480, 640, 75, 0), (333, 517, 85, 1), (257, 256, 100, 2),
          (100, 80, 92, 0), (1024, 768, 95, 2)]


@pytest.fixture
def fresh(monkeypatch):
    """The module's built decoder and remembered failure cleared, and
    restored after the test."""
    monkeypatch.setattr(native, "_decoder", None)
    monkeypatch.setattr(native, "_failed", None)
    monkeypatch.delenv("HST_NATIVE_DECODE_FAST", raising=False)
    return monkeypatch


@pytest.fixture
def decoder(fresh):
    fresh.setenv("HST_NATIVE_DECODE", "1")
    return native.get_decoder()


def _jpeg(arr, **kw):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pil(data, monkeypatch, staging=loader.STAGING_SIZE):
    monkeypatch.setenv("HST_NATIVE_DECODE", "0")
    try:
        return loader.decode_image_staged_bytes(data, staging)
    finally:
        monkeypatch.setenv("HST_NATIVE_DECODE", "1")


def test_builds_into_the_port_build_dir(decoder):
    assert decoder is not None
    build = os.path.join(os.path.dirname(os.path.dirname(native.__file__)), "_build")
    assert os.path.dirname(decoder.so_path) in (build, native._build_dirs()[1])
    assert native._build_dirs()[1].endswith("heuristique_style_transfer_code_tpu_torch")


@pytest.mark.parametrize("w,h,q,sub", SHAPES)
def test_bit_equal_to_pil_and_to_jax(decoder, fresh, w, h, q, sub):
    from heuristique_style_transfer_code_tpu.native import get_decoder as jax_decoder

    rng = np.random.RandomState(w * 7 + h)
    y, x = np.mgrid[0:h, 0:w]
    smooth = np.stack([x * 255 // w, y * 255 // h, (x + y) * 255 // (w + h)], -1)
    arr = np.clip(smooth + rng.randint(-40, 40, (h, w, 3)), 0, 255).astype(np.uint8)
    data = _jpeg(arr, quality=q, subsampling=sub)
    got = loader.decode_image_staged_bytes(data)
    assert got.shape == (loader.STAGING_SIZE, loader.STAGING_SIZE, 3)
    np.testing.assert_array_equal(got, decoder.decode_staged(data))
    np.testing.assert_array_equal(got, _pil(data, fresh))
    np.testing.assert_array_equal(got, jax_decoder().decode_staged(data))


def test_progressive_grayscale_and_other_staging(decoder, fresh):
    rng = np.random.RandomState(3)
    for data, staging in ((_jpeg(rng.randint(0, 256, (480, 640, 3), dtype=np.uint8),
                                 quality=90, progressive=True), 256),
                          (_jpeg(rng.randint(0, 256, (480, 640), dtype=np.uint8)), 256),
                          (_jpeg(rng.randint(0, 256, (300, 500, 3), dtype=np.uint8)), 128)):
        nat = decoder.decode_staged(data, staging)
        assert nat.shape == (staging, staging, 3)
        np.testing.assert_array_equal(nat, _pil(data, fresh, staging))


def test_fallbacks_to_pil(decoder, fresh):
    """CMYK, corrupt and truncated JPEGs are refused by the native path;
    the staged decode then gives PIL's result, and PNGs go to PIL."""
    buf = io.BytesIO()
    Image.new("CMYK", (300, 300), (10, 20, 30, 40)).save(buf, format="JPEG")
    assert decoder.decode_staged(buf.getvalue()) is None
    np.testing.assert_array_equal(loader.decode_image_staged_bytes(buf.getvalue()),
                                  _pil(buf.getvalue(), fresh))
    assert decoder.decode_staged(b"\xff\xd8\xff\xe0 garbage") is None
    rng = np.random.RandomState(10)
    full = _jpeg(rng.randint(0, 256, (480, 640, 3), dtype=np.uint8))
    assert decoder.decode_staged(full[: len(full) // 2]) is None
    png = io.BytesIO()
    Image.fromarray(rng.randint(0, 256, (300, 400, 3), dtype=np.uint8)).save(png, format="PNG")
    assert not native.is_jpeg(png.getvalue()) and native.is_jpeg(full)
    assert loader.decode_image_staged_bytes(png.getvalue()).shape == (256, 256, 3)


def test_modes(fresh):
    """0: no decoder; 1: a failed build raises; auto: a failed build gives
    None (PIL), and the failure is remembered for the process."""
    fresh.setenv("HST_NATIVE_DECODE", "0")
    assert native.get_decoder() is None

    def broken():
        raise RuntimeError("native decoder build failed: no g++")

    fresh.setattr(native, "_compile", broken)
    fresh.setenv("HST_NATIVE_DECODE", "1")
    with pytest.raises(RuntimeError, match="build failed"):
        native.get_decoder()
    fresh.setattr(native, "_failed", None)
    fresh.delenv("HST_NATIVE_DECODE")
    assert native.get_decoder() is None
    assert native._failed is not None
    data = _jpeg(np.random.RandomState(1).randint(0, 256, (300, 400, 3), dtype=np.uint8))
    assert loader.decode_image_staged_bytes(data).shape == (256, 256, 3)


def test_fast_path_close_to_exact(decoder, fresh):
    y, x = np.mgrid[0:1500, 0:2000]
    arr = np.stack([x * 255 // 2000, y * 255 // 1500, (x + y) % 256], -1).astype(np.uint8)
    data = _jpeg(arr, quality=90)
    exact = decoder.decode_staged(data)
    fresh.setenv("HST_NATIVE_DECODE_FAST", "1")
    fast = loader.decode_image_staged_bytes(data)
    d = np.abs(exact.astype(int) - fast.astype(int))
    assert fast.shape == exact.shape and d.mean() < 3.0 and np.percentile(d, 99) <= 25
