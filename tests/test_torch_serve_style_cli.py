"""The port's ``serve_style`` CLI against the JAX one: both serve one
``style_net.npz`` and hyperparameters file that the JAX package wrote, on
``--port 0``, and answer the same raw POST with decoded pixels within one
uint8 step (the same f32 arithmetic in another order; a value within
rounding of a half step may round either way). Also: texture mode, the
"not ported yet" flags and the device rule."""
import json
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


@pytest.mark.parametrize("extra", [
    ["--artifact", "a.npz"], ["--export_artifact", "a.npz"], ["--export_platforms", "cpu"],
    ["--transport", "yuv420"], ["--style_image", "s.png"], ["--style_weight", "2"],
    ["--content_weight", "2"], ["--tv_weight", "1"], ["--style_init", "noise"],
    ["--style_layers", "all"], ["--remat"], ["--recycle_after_requests", "3"],
    ["--family", "multi_patchgan"], ["--devices", "2"], ["--profile_dir", "p"],
    ["--debug_nans"],
])
def test_unported_flags_raise(net_path, extra):
    from heuristique_style_transfer_code_tpu_torch.cli.serve_style import main

    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(["--net", net_path, "--port", "0", "--device", "cpu", *extra])


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(net_path):
    from heuristique_style_transfer_code_tpu_torch.cli.serve_style import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--net", net_path, "--port", "0", "--max_seconds", "0"])
