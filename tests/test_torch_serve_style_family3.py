"""``serve_style --family multi_patchgan`` and the ``yuv420`` transport in
the port against the JAX package, on the CPU.

- ``tasks/camera.rgb_to_yuv420_device`` on batched uint8 equals JAX's
  packer byte for byte (the same f32 formulas, 2x2 chroma means, round
  half to even); its luma is within 1 of cv2's ``COLOR_RGB2YUV_I420`` on
  noise, and its chroma within 1 on a smooth image (cv2 takes each 2x2
  block's top-left chroma sample, not the mean, so on per-pixel noise the
  two chroma planes differ).
- A ``StyleTransferService`` with ``transport="yuv420"`` against JAX's on
  the same job program (the identity: the transport alone): each answer
  within 1 uint8 step of JAX's (the device unpack's f32 rounding), RGB
  whatever the transport.
- ``--family multi_patchgan`` (a family-3 test-variant checkpoint, norm
  "instance" and "batch"): the Gram program against JAX's on the same
  canvas (f32, 1e-4 of its largest entry); the reply served over HTTP, in
  rgb and in yuv420, equal to the service's texture job run in process on
  the same canvas and job id (bit for bit on the CPU; the yuv420 reply is
  cv2's decode of the job's device-packed I420); JAX's ``--layers``
  ValueError word for word.

Sizes: ndf 8, gram dim 8, the default patch sizes (10/70/150), the 224²
canvas the service crops to, 2 iterations at threshold 0, b1."""
import json
import re
import threading
import urllib.request

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.tasks.camera import rgb_to_yuv420_device
from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _smooth(h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    return np.stack([yy * 200 // h + 20, xx * 180 // w + 30, (yy + xx) * 100 // (h + w) + 60],
                    -1).astype(np.uint8)


def test_rgb_to_yuv420_device_matches_jax_and_cv2():
    from heuristique_style_transfer_code_tpu.tasks.camera import rgb_to_yuv420_device as j_pack

    noise = np.random.RandomState(0).randint(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    got = rgb_to_yuv420_device(torch.from_numpy(noise)).numpy()
    want = np.stack([np.asarray(j_pack(jnp.asarray(im))) for im in noise])
    assert got.shape == (2, 48, 48) and got.dtype == np.uint8
    assert np.array_equal(got, want)
    for im, packed in zip(noise, got):
        ref = cv2.cvtColor(im, cv2.COLOR_RGB2YUV_I420).astype(int)
        assert np.abs(packed[:32].astype(int) - ref[:32]).max() <= 1
    smooth = _smooth(224, 224)
    packed = rgb_to_yuv420_device(torch.from_numpy(smooth)).numpy().astype(int)
    assert np.abs(packed - cv2.cvtColor(smooth, cv2.COLOR_RGB2YUV_I420).astype(int)).max() <= 1


def test_yuv420_service_matches_the_jax_service():
    from heuristique_style_transfer_code_tpu.tasks.style_service import (
        StyleTransferService as JService,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.style_service import (
        StyleTransferService,
    )

    rng = np.random.RandomState(1)
    images = [rng.randint(0, 256, (40, 44, 3)).astype(np.uint8), _smooth(32, 32)]
    answers = {}
    for side, service in (
        ("jax", JService(job_fn=lambda u8, w, ids: (u8, 1, jnp.zeros((u8.shape[0],))),
                         crop=32, batch_size=2, transport="yuv420", max_delay_ms=20)),
        ("port", StyleTransferService(
            job_fn=lambda u8, w, ids: (u8, 1, torch.zeros((u8.shape[0],))), crop=32,
            batch_size=2, transport="yuv420", max_delay_ms=20, device="cpu")),
    ):
        with service:
            answers[side] = [f.result(60).image for f in [service.submit(im) for im in images]]
        assert service.stats()["transport"] == "yuv420"
    for got, want in zip(answers["port"], answers["jax"]):
        assert got.shape == want.shape == (32, 32, 3) and got.dtype == np.uint8
        assert np.abs(got.astype(int) - want).max() <= 1


@pytest.fixture(scope="module", params=["instance", "batch"])
def f3_serve(request, tmp_path_factory):
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )

    d = tmp_path_factory.mktemp(f"f3serve_{request.param}")
    model = multiscale_test_init(torch.Generator().manual_seed(0),
                                 {"small": 10, "medium": 70, "large": 150}, ndf=8, num_classes=4,
                                 gram_matrix_dim=8, norm=request.param, device="cpu")
    ckpt = str(d / "model.npz")
    save_pytree_npz(to_jax_tree(model), ckpt)
    cfg = str(d / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"ndf": 8, "gram_matrix_dim": 8, "num_classes": 4, "norm": request.param}, f)
    return ["--family", "multi_patchgan", "--config_path", cfg, "--model_path", ckpt]


def test_family3_gram_program_matches_jax(f3_serve):
    from heuristique_style_transfer_code_tpu.cli import serve_style as j_cli
    from heuristique_style_transfer_code_tpu.data.augment import eval_preprocess as j_pre
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess

    canvas = np.random.RandomState(2).randint(0, 256, (1, 224, 224, 3)).astype(np.uint8)
    j_gram = jax.jit(j_cli._build_gram_fn(j_cli.build_parser().parse_args(f3_serve)))
    want = np.asarray(j_gram(j_pre(jnp.asarray(canvas), 224))[0])
    gram_fn = p_cli._build_gram_fn(p_cli.build_parser().parse_args(f3_serve + ["--device", "cpu"]),
                                   torch.device("cpu"))
    with torch.no_grad():
        got = gram_fn(eval_preprocess(torch.from_numpy(canvas), 224))[0].numpy()
    assert got.shape == want.shape == (1, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def _post(url, img):
    req = urllib.request.Request(url + "/style", data=img.tobytes(), method="POST",
                                 headers={"X-Raw-Shape": ",".join(map(str, img.shape))})
    with urllib.request.urlopen(req, timeout=120) as r:
        return decode_png(r.read()), dict(r.headers)


@pytest.mark.parametrize("transport", ["rgb", "yuv420"])
def test_family3_served_pixels_equal_the_in_process_loop(f3_serve, transport):
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli
    from heuristique_style_transfer_code_tpu_torch.tasks.camera import rgb_to_yuv420

    args = p_cli.build_parser().parse_args(f3_serve + [
        "--num_iterations", "2", "--threshold", "0", "--batch_size", "1", "--port", "0",
        "--max_delay_ms", "10", "--transport", transport, "--no_warmup", "--device", "cpu"])
    srv, service = p_cli.start(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    canvas = np.random.RandomState(3).randint(0, 256, (224, 224, 3)).astype(np.uint8)
    try:
        served, headers = _post(f"http://127.0.0.1:{srv.server_address[1]}", canvas)
        assert headers["X-Iterations"] == "2"
        # job 0 again, in process: the same noise, the same loop
        job_in = rgb_to_yuv420(canvas) if transport == "yuv420" else canvas
        pixels, iters, _ = service._jobs_by_size[1](job_in[None], np.zeros((1, 1), np.float32),
                                                    np.zeros((1,), np.int32))
    finally:
        srv.shutdown()
        srv.server_close()
        service.stop(drain=True)
    want = pixels.numpy()[0]
    if transport == "yuv420":
        assert want.shape == (336, 224)
        want = cv2.cvtColor(want, cv2.COLOR_YUV2RGB_I420)
    assert iters == 2 and served.shape == (224, 224, 3)
    assert np.array_equal(served, want)


def test_layers_keep_the_jax_error(f3_serve):
    from heuristique_style_transfer_code_tpu.cli import serve_style as j_cli
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli

    argv = f3_serve + ["--layers", "5", "--port", "0"]
    with pytest.raises(ValueError) as jax_err:
        j_cli.build_service(j_cli.build_parser().parse_args(argv))
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        p_cli.build_service(p_cli.build_parser().parse_args(argv + ["--device", "cpu"]))
