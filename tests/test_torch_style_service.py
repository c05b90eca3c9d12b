"""The port's style service (``tasks/style_service.py``), its HTTP helpers
and its PNG codec, on the CPU.

Results are compared exactly where the arithmetic is the same (the same net
on one image alone or in a batch; the same job id in two batches of one
size); the error checks take the JAX package's own messages."""
import io
import re
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from heuristique_style_transfer_code_tpu.tasks import style_http as j_http
from heuristique_style_transfer_code_tpu.tasks import style_service as j_service
from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import transformer_net_init
from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import (
    make_net_job_fn,
    make_stylize_fn,
)
from heuristique_style_transfer_code_tpu_torch.tasks.style_http import _parse_style_header
from heuristique_style_transfer_code_tpu_torch.tasks.style_service import (
    StyleTransferService,
    style_weights,
)
from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png, encode_png

TIMEOUT = 120


def _net():
    return transformer_net_init(torch.Generator().manual_seed(0), width=4, n_res=1, device="cpu")


def _imgs(n, size=16, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (size, size, 3)).astype(np.uint8) for _ in range(n)]


def test_job_fn_ladder_answers_each_job_as_if_alone():
    net = _net()
    job = make_net_job_fn(net, crop=16)
    svc = StyleTransferService(job_fn={1: job, 2: job}, style_names=["s"], crop=16,
                               max_delay_ms=50, device="cpu").start()
    try:
        assert svc.batch_sizes == [1, 2]
        imgs = _imgs(3)
        futs = [svc.submit(im) for im in imgs]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        stats = svc.stats()
    finally:
        svc.stop()
    alone = make_stylize_fn(net, crop=16)
    for im, r in zip(imgs, results):
        assert r.iterations == 1 and r.loss == 0.0 and r.image.shape == (16, 16, 3)
        np.testing.assert_array_equal(r.image, alone(im[None]).numpy()[0])
    assert stats["jobs"] == 3 and sum(stats["batch_size_hist"].values()) == stats["batches"]


def test_failing_job_answers_with_its_error_and_counts_toward_health():
    def job(images_u8, style_w, job_ids):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    svc = StyleTransferService(job_fn=job, batch_size=1, crop=16, max_delay_ms=1,
                               device="cpu").start()
    try:
        for _ in range(3):
            with pytest.raises(RuntimeError, match="illegal memory access"):
                svc.submit(_imgs(1)[0]).result(timeout=TIMEOUT)
        ok, reason = svc.health()
    finally:
        svc.stop()
    assert not ok and "3 consecutive batch errors" in reason


@pytest.mark.parametrize("style", [
    "nope", {"a": -1.0}, {"a": 0.0, "b": 0.0}, {"zz": 1.0}, {"a": float("nan")},
])
def test_style_weights_errors_match_jax(style):
    names = ["a", "b"]
    with pytest.raises(ValueError) as want:
        j_service.style_weights(style, names)
    with pytest.raises(ValueError) as got:
        style_weights(style, names)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("style", [None, "b", {"a": 1.0, "b": 3.0}])
def test_style_weights_equal_jax(style):
    np.testing.assert_array_equal(style_weights(style, ["a", "b"]),
                                  j_service.style_weights(style, ["a", "b"]))


@pytest.mark.parametrize("value", [None, "vangogh", "a:0.7,b:0.3", "a,b", ",a", "a:x"])
def test_parse_style_header_matches_jax(value):
    try:
        want = j_http._parse_style_header(value)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            _parse_style_header(value)
        return
    assert _parse_style_header(value) == want


def test_texture_mode_job_is_independent_of_its_batch_mates():
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_gram_attention,
    )

    model = gram_attention_init(torch.Generator().manual_seed(0), 4, 4, 4, device="cpu")
    gram_fn = make_gram_fn_gram_attention(model, 4)
    first, a, b = _imgs(3, seed=5)
    out = []
    for mate in (a, b):  # job 0 is `first` in both, batched with another image
        svc = StyleTransferService(gram_fn, crop=16, batch_size=2, num_iterations=2,
                                   threshold=0.0, max_delay_ms=2000, seed=3,
                                   device="cpu").start()
        try:
            futs = [svc.submit(first), svc.submit(mate)]
            res = [f.result(timeout=TIMEOUT) for f in futs]
            assert svc.stats()["batch_size_hist"] == {"2": 1}
        finally:
            svc.stop()
        assert all(r.iterations == 2 for r in res)
        out.append(res[0])
    np.testing.assert_array_equal(out[0].image, out[1].image)
    assert out[0].loss == out[1].loss


def test_stop_drains_then_refuses():
    svc = StyleTransferService(job_fn=make_net_job_fn(_net(), crop=16), batch_size=2, crop=16,
                               max_delay_ms=500, device="cpu").start()
    futs = [svc.submit(im) for im in _imgs(5)]
    svc.stop(drain=True)
    assert all(f.done() and not f.cancelled() for f in futs)
    assert all(f.result().image.shape == (16, 16, 3) for f in futs)
    with pytest.raises(RuntimeError, match="service is stopped"):
        svc.submit(_imgs(1)[0])


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError, match="not ported yet"):
        StyleTransferService(extract_fn=lambda x: x, styles={"a": _imgs(1)[0]}, device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        StyleTransferService(job_fn=lambda *a: a, transport="yuv420", device="cpu")


def _filtered_png(rgb, kind):
    """A PNG (RGB, or RGBA for 4 channels) whose every scanline uses filter
    ``kind`` (0-4), written here so that each filter is read at least once
    whatever Pillow chooses."""
    h, w, ch = rgb.shape
    x = rgb.reshape(h, w * ch).astype(np.int32)
    rows = []
    for y in range(h):
        cur, up = x[y], (x[y - 1] if y else np.zeros(w * ch, np.int32))
        left = np.concatenate([np.zeros(ch, np.int32), cur[:-ch]])
        ul = np.concatenate([np.zeros(ch, np.int32), up[:-ch]])
        if kind == 0:
            f = cur
        elif kind == 1:
            f = cur - left
        elif kind == 2:
            f = cur - up
        elif kind == 3:
            f = cur - (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        rows.append(np.concatenate([[kind], f % 256]).astype(np.uint8))

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    colour = {3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(np.stack(rows).tobytes())) + chunk(b"IEND", b""))


def _rgb(h=23, w=31, seed=0):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([xx * 7, yy * 9, (xx + yy) * 4], -1).astype(np.uint8)
    noise = np.random.RandomState(seed).randint(0, 40, img.shape)
    return (img + noise).astype(np.uint8)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_decode_png_reads_each_filter_type(kind):
    rgb = _rgb()
    data = _filtered_png(rgb, kind)
    with Image.open(io.BytesIO(data)) as im:  # a valid file: Pillow reads it the same
        np.testing.assert_array_equal(np.asarray(im), rgb)
    np.testing.assert_array_equal(decode_png(data), rgb)


def test_decode_png_reads_pillow_files_and_pillow_reads_encode_png():
    rgb = _rgb(64, 48, seed=1)
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), rgb)
    with Image.open(io.BytesIO(encode_png(rgb))) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), rgb)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a")


def _rgba(h=23, w=31, seed=2):
    alpha = np.random.RandomState(seed).randint(0, 256, (h, w, 1)).astype(np.uint8)
    return np.concatenate([_rgb(h, w, seed), alpha], axis=-1)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_decode_png_reads_rgba_with_each_filter_type(kind):
    """Colour type 6 (the style-transfer files): four bytes a pixel, so the
    Sub, Average and Paeth filters reach four bytes back."""
    rgba = _rgba()
    data = _filtered_png(rgba, kind)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGBA"
        np.testing.assert_array_equal(np.asarray(im), rgba)
    np.testing.assert_array_equal(decode_png(data), rgba)


def test_encode_png_rgba_round_trips_through_decode_png_and_pillow():
    rgba = _rgba(40, 24, seed=3)
    data = encode_png(rgba)
    np.testing.assert_array_equal(decode_png(data), rgba)
    with Image.open(io.BytesIO(data)) as im:
        assert im.mode == "RGBA"
        np.testing.assert_array_equal(np.asarray(im), rgba)
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, format="PNG")
    np.testing.assert_array_equal(decode_png(buf.getvalue()), rgba)
    with pytest.raises(ValueError, match="3|4"):
        encode_png(rgba[..., :2])
