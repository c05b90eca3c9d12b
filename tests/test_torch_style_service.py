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


def _content_style_services(init="content", styles_n=2, crop=32):
    """The JAX service and the port's in content+style mode on the same
    seeded family-2 weights (truncate 5, style_layers "all"), gallery and
    loop settings; neither started (their job programs are called
    directly)."""
    from heuristique_style_transfer_code_tpu.tasks import style_transfer as jst
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    model = gram_attention_init(torch.Generator().manual_seed(0), 5, 4, 4, device="cpu")
    tree = to_jax_tree(model)
    styles = dict(zip("ab", _imgs(styles_n, size=40, seed=9)))
    kw = dict(styles=styles, style_weight=2.0, content_weight=0.5, tv_weight=0.05, init=init,
              crop=crop, batch_size=2, num_iterations=2, threshold=0.0, seed=3)
    j_svc = j_service.StyleTransferService(
        extract_fn=jst.make_extract_fn_gram_attention(tree, 5, style_layers="all"), **kw)
    svc = StyleTransferService(
        extract_fn=pst.make_extract_fn_gram_attention(model, 5, style_layers="all"),
        device="cpu", **kw)
    return j_svc, svc


@pytest.mark.parametrize("weights", [[1.0, 0.0], [0.0, 1.0], [0.5, 0.5]])
def test_content_style_job_matches_jax(weights):
    """One batch of two jobs on each side's job program. Tolerance: after 2
    Adam steps from the content image a pixel whose gradient is within the
    f32 error of zero may step the other way (lr each step), so the canvases
    agree within 1 uint8 step at 99% of values and all within
    ceil(2·lr·2·0.229·255) + 1 = 4; losses within 1e-4 relative."""
    j_svc, svc = _content_style_services()
    assert svc.style_names == j_svc.style_names == ["a", "b"]
    images = np.stack(_imgs(2, size=32, seed=10))
    w = np.array([weights, weights], np.float32)
    ids = np.arange(2, dtype=np.int32)
    j_u8, j_iters, j_per = (np.asarray(a) for a in j_svc._jobs_by_size[2](images, w, ids))
    u8, iters, per = svc._jobs_by_size[2](images, w, ids)
    assert iters == int(j_iters) == 2 and u8.shape == (2, 32, 32, 3)
    gap = np.abs(u8.numpy().astype(np.int16) - j_u8.astype(np.int16))
    assert (gap <= 1).mean() >= 0.99 and gap.max() <= 4, gap.max()
    np.testing.assert_allclose(per.numpy(), j_per, rtol=1e-4)


def test_content_style_one_hot_equals_indexing():
    """A one-hot row of the gallery blend gives that style's Gram bit for
    bit: the job equals the job of a one-style gallery holding it."""
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_extract_fn_gram_attention,
    )

    extract = make_extract_fn_gram_attention(
        gram_attention_init(torch.Generator().manual_seed(0), 5, 4, 4, device="cpu"), 5,
        style_layers="all")
    a, b = _imgs(2, size=40, seed=9)
    kw = dict(crop=32, batch_size=1, num_iterations=2, threshold=0.0, device="cpu")
    both = StyleTransferService(extract_fn=extract, styles={"a": a, "b": b}, **kw)
    only_b = StyleTransferService(extract_fn=extract, styles={"b": b}, **kw)
    image = np.stack(_imgs(1, size=32, seed=10))
    ids = np.zeros((1,), np.int32)
    got = both._jobs_by_size[1](image, np.array([[0.0, 1.0]], np.float32), ids)
    want = only_b._jobs_by_size[1](image, np.array([[1.0]], np.float32), ids)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)
    torch.testing.assert_close(got[2], want[2], rtol=0, atol=0)


def test_content_style_service_answers_named_and_blended_jobs():
    _, svc = _content_style_services(init="noise")
    svc.start()
    try:
        futs = [svc.submit(im, style=st) for im, st in
                zip(_imgs(3, size=32, seed=11), ["a", {"a": 1, "b": 3}, None])]
        res = [f.result(timeout=TIMEOUT) for f in futs]
        with pytest.raises(ValueError, match="unknown style"):
            svc.submit(_imgs(1)[0], style="c")
    finally:
        svc.stop()
    assert all(r.iterations == 2 and r.image.shape == (32, 32, 3) for r in res)
    assert all(np.isfinite(r.loss) and r.loss > 0 for r in res)


@pytest.mark.parametrize("case", ["two_programs", "no_styles", "styles_without_extract",
                                  "bad_init"])
def test_content_style_errors_keep_the_jax_messages(case):
    fn = lambda x: x  # noqa: E731  (never called: the checks come first)
    styles = {"a": _imgs(1)[0]}
    kwargs = {"two_programs": dict(gram_fn=fn, extract_fn=fn, styles=styles),
              "no_styles": dict(extract_fn=fn),
              "styles_without_extract": dict(gram_fn=fn, styles=styles),
              "bad_init": dict(extract_fn=fn, styles=styles, init="zeros")}[case]
    with pytest.raises(ValueError) as jax_err:
        j_service.StyleTransferService(**kwargs)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        StyleTransferService(device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs", [dict(transport="yuv422"),
                                    dict(transport="yuv420", crop=30)])
def test_unported_modes_raise(kwargs):
    """The yuv420 transport is ported (``test_torch_serve_style_family3.py``
    holds it against JAX); an unknown transport and a crop that I420's
    planes cannot hold keep the JAX service's ValueErrors word for word."""
    with pytest.raises(ValueError) as jax_err:
        j_service.StyleTransferService(job_fn=lambda *a: a, **kwargs)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        StyleTransferService(job_fn=lambda *a: a, device="cpu", **kwargs)


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
