"""The port's ``serve_style`` CLI against the JAX one: both serve one
``style_net.npz`` and hyperparameters file that the JAX package wrote, on
``--port 0``, and answer the same raw POST with decoded pixels within one
uint8 step (the same f32 arithmetic in another order; a value within
rounding of a half step may round either way). Also: texture mode,
content+style mode (``--style_image``) and its errors, the "not ported
yet" flags and the device rule."""
import json
import os
import re
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.checkpoint.io import save_model_and_hyperparameters
from heuristique_style_transfer_code_tpu.nn.transformer_net import transformer_net_init
from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

CROP = 32


@pytest.fixture(scope="module")
def net_path(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("style_net"))
    params = jax.tree_util.tree_map(
        np.asarray, transformer_net_init(jax.random.PRNGKey(0), width=4, n_res=2))
    return save_model_and_hyperparameters(params, {"crop": CROP, "style_names": ["stripes"]},
                                          d, "style_net")


def _serve(start, argv_parser, argv):
    args = argv_parser().parse_args(argv)
    srv, service = start(args)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, service, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, service):
    srv.shutdown()
    srv.server_close()
    service.stop(drain=True)


def _post(url, img):
    req = urllib.request.Request(url + "/style", data=img.tobytes(), method="POST",
                                 headers={"X-Raw-Shape": ",".join(map(str, img.shape))})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.read(), dict(r.headers)


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=60) as r:
        return r.status, r.read().decode()


def test_port_net_server_answers_as_the_jax_one(net_path):
    from heuristique_style_transfer_code_tpu.cli import serve_style as j_cli
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli

    img = np.random.RandomState(0).randint(0, 256, (40, 40, 3)).astype(np.uint8)
    flags = ["--net", net_path, "--batch_size", "1,2", "--port", "0", "--max_delay_ms", "20"]
    answers = {}
    for side, cli, extra in (("jax", j_cli, []), ("port", p_cli, ["--device", "cpu"])):
        srv, service, url = _serve(cli.start, cli.build_parser, flags + extra)
        try:
            png, headers = _post(url, img)
            answers[side] = decode_png(png)
            assert headers["X-Iterations"] == "1"
            if side == "port":
                assert float(headers["X-Final-Loss"]) == 0.0
                assert _get(url, "/healthz") == (200, '{"ok": true}')
                assert json.loads(_get(url, "/styles")[1]) == {"styles": ["stripes"]}
                stats = json.loads(_get(url, "/stats")[1])
                assert stats["jobs"] == 1 and stats["batch_size_hist"] == {"1": 1}
                status, metrics = _get(url, "/metrics")
                assert status == 200 and "hst_style_jobs_total 1" in metrics
        finally:
            _stop(srv, service)
    assert answers["port"].shape == (CROP, CROP, 3)
    d = np.abs(answers["port"].astype(np.int16) - answers["jax"].astype(np.int16))
    assert d.max() <= 1, d.max()


def test_port_texture_server_runs_the_loop(tmp_path):
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    ckpt = str(tmp_path / "model.npz")
    save_pytree_npz(to_jax_tree(gram_attention_init(torch.Generator().manual_seed(0), 5, 4, 4,
                                                    device="cpu")), ckpt)
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 2, "truncate_layer": 5, "gram_matrix_size": 4}, f)
    srv, service, url = _serve(p_cli.start, p_cli.build_parser, [
        "--config_path", cfg, "--model_path", ckpt, "--layers", "5", "--num_iterations", "2",
        "--threshold", "0", "--batch_size", "2", "--port", "0", "--max_delay_ms", "20",
        "--device", "cpu"])
    try:
        png, headers = _post(url, np.zeros((224, 224, 3), np.uint8))
        assert headers["X-Iterations"] == "2" and float(headers["X-Final-Loss"]) >= 0.0
        assert decode_png(png).shape == (224, 224, 3)
        assert json.loads(_get(url, "/styles")[1]) == {"styles": []}
    finally:
        _stop(srv, service)


@pytest.fixture(scope="module")
def content_style_files(tmp_path_factory):
    """A seeded family-2 npz (truncate 5), its config and two style PNGs."""
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    d = tmp_path_factory.mktemp("content_style")
    ckpt = str(d / "model.npz")
    save_pytree_npz(to_jax_tree(gram_attention_init(torch.Generator().manual_seed(0), 5, 4, 4,
                                                    device="cpu")), ckpt)
    cfg = str(d / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 2, "truncate_layer": 5, "gram_matrix_size": 4}, f)
    rng = np.random.RandomState(3)
    paths = []
    for name in ("a", "b"):
        paths.append(str(d / f"{name}.png"))
        Image.fromarray(rng.randint(0, 256, (60, 80, 3)).astype(np.uint8)).save(paths[-1])
    return cfg, ckpt, paths


def test_port_content_style_server(content_style_files):
    """--style_image NAME=PATH twice: GET /styles lists the gallery, and a
    named POST and a blended one (X-Style) answer after the iterations
    asked for."""
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli

    cfg, ckpt, (a, b) = content_style_files
    srv, service, url = _serve(p_cli.start, p_cli.build_parser, [
        "--config_path", cfg, "--model_path", ckpt, "--layers", "5", "--num_iterations", "2",
        "--threshold", "0", "--batch_size", "2", "--port", "0", "--max_delay_ms", "20",
        "--style_image", f"a={a}", "--style_image", b, "--style_layers", "all",
        "--style_weight", "2", "--content_weight", "0.5", "--tv_weight", "0.05",
        "--style_init", "noise", "--device", "cpu"])
    try:
        assert json.loads(_get(url, "/styles")[1]) == {"styles": ["a", "b"]}
        img = np.random.RandomState(4).randint(0, 256, (224, 224, 3)).astype(np.uint8)
        for style in ("b", "a:0.5,b:0.5"):
            req = urllib.request.Request(url + "/style", data=img.tobytes(), method="POST",
                                         headers={"X-Raw-Shape": "224,224,3", "X-Style": style})
            with urllib.request.urlopen(req, timeout=120) as r:
                png, headers = r.read(), dict(r.headers)
            assert headers["X-Iterations"] == "2" and float(headers["X-Final-Loss"]) > 0
            assert decode_png(png).shape == (224, 224, 3)
    finally:
        _stop(srv, service)


@pytest.mark.parametrize("case", ["duplicate_name", "bare_path_duplicate", "family"])
def test_style_image_errors_keep_the_jax_messages(content_style_files, case):
    from heuristique_style_transfer_code_tpu.cli import serve_style as j_cli
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli

    cfg, ckpt, (a, b) = content_style_files
    extra = {"duplicate_name": ["--style_image", f"a={a}", "--style_image", f"a={b}"],
             "bare_path_duplicate": ["--style_image", a, "--style_image", f"a={b}"],
             "family": ["--style_image", f"a={a}", "--family", "multi_patchgan"]}[case]
    argv = ["--config_path", cfg, "--model_path", ckpt, "--port", "0", *extra]
    with pytest.raises(ValueError) as jax_err:
        j_cli.build_service(j_cli.build_parser().parse_args(argv))
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        p_cli.build_service(p_cli.build_parser().parse_args(argv + ["--device", "cpu"]))


@pytest.mark.parametrize("extra", [
    ["--artifact", "a.npz", "--devices", "2"], ["--export_artifact", "a.npz", "--devices", "2"],
    ["--export_platforms", "cpu", "--devices", "2"], ["--devices", "1"], ["--devices", "2"],
])
def test_unported_flags_raise(net_path, extra):
    """``--devices`` is not ported, alone or with the artifact flags."""
    from heuristique_style_transfer_code_tpu_torch.cli.serve_style import main

    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(["--net", net_path, "--port", "0", "--device", "cpu", *extra])


def _post_through_main(cli, argv, img, monkeypatch):
    """``cli.main(argv)`` (the whole CLI, with its ``--profile_dir`` and
    ``--debug_nans`` around the server) in a thread until ``--max_seconds``
    ends it; one POST of ``img`` while it serves. Returns the decoded
    answer."""
    started = {}
    start = cli.start

    def recording_start(args, crop=224):
        srv, service = start(args, crop)
        started["url"] = f"http://127.0.0.1:{srv.server_address[1]}"
        return srv, service

    monkeypatch.setattr(cli, "start", recording_start)
    runner = threading.Thread(target=cli.main, args=(argv + ["--max_seconds", "2"],))
    runner.start()
    try:
        for _ in range(600):
            if "url" in started or not runner.is_alive():
                break
            runner.join(0.01)
        answer = decode_png(_post(started["url"], img)[0])
    finally:
        runner.join(60)
    assert not runner.is_alive()
    return answer


@pytest.mark.parametrize("extra", [
    ["--transport", "yuv420"], ["--remat"], ["--family", "multi_patchgan"],
    ["--profile_dir", "PROFILE"], ["--debug_nans"],
])
def test_flags_ported_with_a_net(net_path, tmp_path, monkeypatch, extra):
    """With ``--net`` these flags serve the net: ``--remat`` and
    ``--family`` (texture mode's) leave its answer as it was, as in the
    JAX CLI, and so do ``--profile_dir`` (whose Chrome trace is in its
    directory once the CLI returns) and ``--debug_nans`` (a clean net),
    each through the whole CLI; ``--transport yuv420`` answers RGB within 3
    uint8 steps of the JAX server's yuv420 answer (the same net in another
    summation order, through the device packer's rounding and cv2's I420
    decode on both sides: one chroma step is up to 2 RGB steps; measured
    2)."""
    from heuristique_style_transfer_code_tpu.cli import serve_style as j_cli
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_cli

    extra = [str(tmp_path / "prof") if e == "PROFILE" else e for e in extra]
    img = np.random.RandomState(1).randint(0, 256, (40, 40, 3)).astype(np.uint8)
    flags = ["--net", net_path, "--port", "0", "--max_delay_ms", "20"]
    yuv = extra == ["--transport", "yuv420"]
    want_cli, want_extra = (j_cli, extra) if yuv else (p_cli, ["--device", "cpu"])
    srv, service, url = _serve(want_cli.start, want_cli.build_parser, flags + want_extra)
    try:
        want = decode_png(_post(url, img)[0]).astype(int)
    finally:
        _stop(srv, service)
    got = _post_through_main(p_cli, flags + extra + ["--device", "cpu"], img,
                             monkeypatch).astype(int)
    assert got.shape == (CROP, CROP, 3)
    assert np.abs(got - want).max() <= (3 if yuv else 0)
    if "--profile_dir" in extra:
        assert any(n.endswith(".pt.trace.json") for n in os.listdir(tmp_path / "prof"))


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(net_path):
    from heuristique_style_transfer_code_tpu_torch.cli.serve_style import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--net", net_path, "--port", "0", "--max_seconds", "0"])
