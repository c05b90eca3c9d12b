"""``serve`` and ``serve_style`` with ``--export_artifact`` and
``--artifact``, and the style artifacts against the JAX package's, on the
CPU.

- ``serve --export_artifact`` then ``serve --artifact`` (family 2, in
  process, over HTTP): the answer equal to live serving's bit for bit, with
  no config or checkpoint given; ``--precision bf16`` with ``--artifact``
  and ``--artifact`` with ``--export_artifact`` raise JAX's errors; the
  ``--recycle_after_requests`` worker, built in its process, serves the
  artifact;
- ``serve_style --export_artifact`` then ``--artifact`` in texture mode
  (family 2, layers 5, 2 iterations, batch 2): the job against the live
  service's (the same noise: iterations equal, losses
  within 1e-5 relative, uint8 within one level), the graphs holding
  ``hst.gram_fwd`` and ``hst.gram_bwd``, and one POST;
- the net artifact (``--net``, batch sizes 1 and 2) against JAX's net
  artifact, and the
  content+style artifact (init "content", so no noise: comparable) against
  JAX's style artifact, 2 iterations: iterations equal, uint8 within one
  level.

Sizes: family 2 at truncate 5, S 4 (a seeded port model in the JAX
layout); the net at width 4, 2 residual blocks, crop 32; the style
services' crop 64 where the CLI's ``build_service`` takes one (224 through
``main``)."""
import http.client
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.cli import serve as jcli
from heuristique_style_transfer_code_tpu.cli import serve_style as jstyle
from heuristique_style_transfer_code_tpu.deploy import artifact as jart
from heuristique_style_transfer_code_tpu_torch.cli import serve as tcli
from heuristique_style_transfer_code_tpu_torch.cli import serve_style as pstyle
from heuristique_style_transfer_code_tpu_torch.deploy import artifact as tart
from heuristique_style_transfer_code_tpu_torch.tasks.serving import BatchingInferenceServer


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def f2(tmp_path_factory):
    """(config, checkpoint) of a seeded family-2 model in the JAX layout."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    d = tmp_path_factory.mktemp("serve_artifact")
    cfg, ckpt = str(d / "f2.json"), str(d / "f2.npz")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "gram_matrix_size": 4,
                   "num_classes": 4, "seed": 0}, f)
    save_pytree_npz(to_jax_tree(gram_attention_init(torch.Generator().manual_seed(0), 5, 4, 4,
                                                    device="cpu")), ckpt)
    return cfg, ckpt


def _f2_argv(f2, *extra):
    return ["--family", "gram_attention", "--config_path", f2[0], "--model_path", f2[1],
            "--batch_size", "2", *extra]


def _predict(srv, frame):
    host, port = srv.server_address
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", "/predict", body=frame.tobytes(),
                 headers={"X-Raw-Shape": ",".join(map(str, frame.shape))})
    r = conn.getresponse()
    assert r.status == 200
    return json.loads(r.read())


def test_serve_exports_and_serves_the_artifact(f2, tmp_path, capsys):
    path = str(tmp_path / "f2.npz")
    tcli.main(_f2_argv(f2, "--device", "cpu", "--export_artifact", path))
    assert "Artifact exported to " + path in capsys.readouterr().out
    args = tcli.build_parser().parse_args(
        ["--artifact", path, "--batch_size", "2", "--port", "0", "--device", "cpu",
         "--max_delay_ms", "5"])
    srv, batcher = tcli.start(args)
    frame = np.random.RandomState(4).randint(0, 256, (224, 224, 3)).astype(np.uint8)
    try:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out = _predict(srv, frame)
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop(drain=True)
    printed = capsys.readouterr().out
    assert f"Serving artifact {path} [gram_attention] on http://" in printed
    fwd, model, _, _ = tcli._resolve_forward(tcli.build_parser().parse_args(
        _f2_argv(f2, "--device", "cpu")))
    with BatchingInferenceServer(fwd, model, batch_size=2, max_delay_ms=5) as live:
        want = live.submit(frame).result(timeout=120)
    np.testing.assert_array_equal(np.asarray(out["probs"], np.float32), want)
    assert out["class"] == ["fog", "rain", "snow", "sun"][int(np.argmax(want))]


@pytest.mark.parametrize("extra", [["--precision", "bf16"], ["--export_artifact", "b.npz"]],
                         ids=["precision", "export"])
def test_serve_artifact_errors_are_jax(f2, extra):
    argv = ["--artifact", "a.npz", "--port", "0", *extra]
    with pytest.raises(ValueError) as want:
        jcli.main(argv)
    with pytest.raises(ValueError) as got:
        tcli.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value)


def test_recycle_worker_builds_from_the_artifact(f2, tmp_path):
    path = str(tmp_path / "f2.npz")
    tcli.main(_f2_argv(f2, "--device", "cpu", "--export_artifact", path))
    batcher, info = tcli._recycle_worker(["--artifact", path, "--batch_size", "2", "--port", "0",
                                          "--device", "cpu", "--no_warmup"])
    frame = np.random.RandomState(5).randint(0, 256, (224, 224, 3)).astype(np.uint8)
    try:
        got = batcher.submit(frame).result(timeout=120)
    finally:
        batcher.stop(drain=True)
    assert info["served"] == f"artifact {path} [gram_attention]"
    assert info["crop"] == 224 and info["transport"] == "rgb"
    want = tart.load_infer_artifact(path, device="cpu")(np.stack([frame, frame]))[0]
    np.testing.assert_array_equal(got, want.numpy())


def _jobs_agree(live, art, batch, styles, seed, loss_rtol=1e-5):
    images = np.random.RandomState(seed).randint(
        0, 256, (batch, live.crop, live.crop, 3)).astype(np.uint8)
    w = np.zeros((batch, styles), np.float32)
    w[np.arange(batch), np.arange(batch) % styles] = 1.0
    ids = np.arange(batch, dtype=np.int32) + 5
    u8, iters, loss = live(images, w, ids)
    a_u8, a_iters, a_loss = art(images, w, ids)
    assert int(iters) == int(a_iters)
    u8, a_u8 = np.asarray(u8), np.asarray(a_u8)
    assert u8.shape == a_u8.shape == (batch, live.crop, live.crop, 3)
    assert np.abs(u8.astype(int) - a_u8.astype(int)).max() <= 1
    np.testing.assert_allclose(np.asarray(a_loss), np.asarray(loss), rtol=loss_rtol, atol=0)


class _Job:
    """A service's batch-``b`` job as ``(images, w, ids)``, its crop kept."""

    def __init__(self, fn, crop):
        self.fn, self.crop = fn, crop

    def __call__(self, images, w, ids):
        return self.fn(images, w, ids)


def test_serve_style_texture_artifact_is_the_live_service(f2, tmp_path, capsys):
    argv = ["--config_path", f2[0], "--model_path", f2[1], "--layers", "5", "--num_iterations",
            "2", "--threshold", "0", "--batch_size", "2", "--port", "0", "--device", "cpu"]
    path = str(tmp_path / "texture.npz")
    pstyle.main(argv + ["--export_artifact", path])
    assert "Style artifact written to " + path in capsys.readouterr().out
    live = pstyle.build_service(pstyle.build_parser().parse_args(argv))
    served = pstyle.build_service(pstyle.build_parser().parse_args(argv + ["--artifact", path]))
    assert served.batch_sizes == [2] and served.num_iterations == 2
    _jobs_agree(_Job(live._jobs_by_size[2], 224), served._jobs_by_size[2], 2, 1, seed=2)
    art = tart.load_style_artifact(path, device="cpu")
    assert art.meta["mode"] == "loop" and art.meta["noise"] and art.meta["seed"] == 0
    nodes = {name: {str(n.target) for n in ep.graph.nodes if str(n.target).startswith("hst.")}
             for name, ep in art.exported_by_size[2].items()}
    assert nodes == {"prepare": {"hst.gram_fwd.default"},
                     "step": {"hst.gram_fwd.default", "hst.gram_bwd.default"}, "finish": set()}
    srv, service = pstyle.start(pstyle.build_parser().parse_args(
        argv + ["--artifact", path, "--no_warmup"]))
    try:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        host, port = srv.server_address[:2]
        conn = http.client.HTTPConnection(host, port, timeout=120)
        img = np.random.RandomState(6).randint(0, 256, (224, 224, 3)).astype(np.uint8)
        conn.request("POST", "/style", body=img.tobytes(), headers={"X-Raw-Shape": "224,224,3"})
        r = conn.getresponse()
        assert r.status == 200 and r.getheader("X-Iterations") == "2"
    finally:
        srv.shutdown()
        srv.server_close()
        service.stop(drain=True)


def test_net_artifact_matches_jax(tmp_path):
    from heuristique_style_transfer_code_tpu.checkpoint.io import save_model_and_hyperparameters
    from heuristique_style_transfer_code_tpu.nn.transformer_net import transformer_net_init

    params = jax.tree_util.tree_map(
        np.asarray, transformer_net_init(jax.random.PRNGKey(0), width=4, n_res=2))
    net = save_model_and_hyperparameters(params, {"crop": 32, "style_names": ["s"]},
                                         str(tmp_path), "style_net")
    argv = ["--net", net, "--batch_size", "1,2"]
    jservice = jstyle.build_service(jstyle.build_parser().parse_args(argv))
    jblobs, jmeta = jart.export_style_artifact(jservice)
    jart.save_style_artifact(str(tmp_path / "jax.npz"), jblobs, jmeta)
    jax_art = jart.load_style_artifact(str(tmp_path / "jax.npz"))
    pservice = pstyle.build_service(pstyle.build_parser().parse_args(argv + ["--device", "cpu"]))
    blobs, meta = tart.export_style_artifact(pservice)
    assert meta["mode"] == "net" and meta["crop"] == 32 and meta["batch_sizes"] == [1, 2]
    tart.save_style_artifact(str(tmp_path / "port.npz"), blobs, meta)
    art = tart.load_style_artifact(str(tmp_path / "port.npz"), device="cpu")
    for b in (1, 2):
        nodes = {str(n.target) for n in art.exported_by_size[b]["job"].graph.nodes}
        assert "hst.instance_norm_fwd.default" in nodes

        def jax_job(images, w, ids, _b=b):
            u8, iters, loss = jax_art.job_fns[_b](jnp.asarray(images), jnp.asarray(w),
                                                  jnp.asarray(ids))
            return np.asarray(u8), int(iters), np.asarray(loss)

        _jobs_agree(_Job(jax_job, 32), art.job_fns[b], b, 1, seed=b, loss_rtol=0)


def test_content_style_artifact_matches_jax(f2, tmp_path):
    from PIL import Image

    styles = []
    for k in range(2):
        p = str(tmp_path / f"style_{k}.png")
        Image.fromarray(np.random.RandomState(20 + k).randint(0, 256, (80, 72, 3)).astype(
            np.uint8)).save(p)
        styles.append(p)
    argv = ["--config_path", f2[0], "--model_path", f2[1], "--style_image", f"a={styles[0]}",
            "--style_image", f"b={styles[1]}", "--num_iterations", "2", "--threshold", "0",
            "--batch_size", "2"]
    jservice = jstyle.build_service(jstyle.build_parser().parse_args(argv), crop=64)
    jblobs, jmeta = jart.export_style_artifact(jservice)
    jart.save_style_artifact(str(tmp_path / "jax.npz"), jblobs, jmeta)
    jax_art = jart.load_style_artifact(str(tmp_path / "jax.npz"))
    pservice = pstyle.build_service(pstyle.build_parser().parse_args(argv + ["--device", "cpu"]),
                                    crop=64)
    blobs, meta = tart.export_style_artifact(pservice)
    assert meta["style_names"] == jmeta["style_names"] == ["a", "b"] and not meta["noise"]
    tart.save_style_artifact(str(tmp_path / "port.npz"), blobs, meta)
    art = tart.load_style_artifact(str(tmp_path / "port.npz"), device="cpu")

    def jax_job(images, w, ids):
        u8, iters, loss = jax_art.job_fns[2](jnp.asarray(images), jnp.asarray(w),
                                             jnp.asarray(ids))
        return np.asarray(u8), int(iters), np.asarray(loss)

    _jobs_agree(_Job(jax_job, 64), art.job_fns[2], 2, 2, seed=7, loss_rtol=1e-3)
