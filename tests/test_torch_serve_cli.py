"""The port's ``cli/serve.py`` against the JAX one, on the CPU.

- ``_build_forward`` of the three families (family 3 at norm "instance"
  and "batch") on one JAX-written ``.npz`` each: logits within rtol =
  atol = 1e-4 of JAX's on the same images;
- the served probabilities of ``_resolve_forward`` through the batcher,
  against JAX's ``_resolve_forward`` through JAX's batcher on the same
  frames: f32 (1e-4) and bf16 (5e-2, JAX's cast path: images cast,
  parameters cast at each op) for the three families, yuv420, and int8
  for families 1 and 2 on one quantised tree (the port calibrates and
  writes it, JAX reads it; 1e-3 and the argmax equal, the tolerance of
  ``tests/test_torch_int8.py``); family 3 under int8 refused with JAX's
  message;
- the moco-only ``KeyError``; the parser against JAX's (every flag, its
  default and choices, plus ``--device``); the flags that are not ported;
  ``--device cuda`` without a card; ``start`` over HTTP; the wiring of
  ``start_recycling`` (no worker spawned here); ``--profile_dir``; and the
  SIGTERM drain of a real process.

Sizes: truncate 5, dim 16 (family 1), S 4 (family 2), 4 classes, batch 2
at 64 px; family 3 at patch sizes 10/20/40 and ndf 8 at 224 px (its
scales take 224², 112² and 56²)."""
import argparse
import http.client
import json
import os
import signal
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.cli import serve as jcli
from heuristique_style_transfer_code_tpu.tasks.serving import BatchingInferenceServer as JServer
from heuristique_style_transfer_code_tpu_torch.cli import serve as tcli
from heuristique_style_transfer_code_tpu_torch.tasks.serving import BatchingInferenceServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CROP = 64
TOL = {"float32": dict(rtol=1e-4, atol=1e-4), "bf16": dict(rtol=5e-2, atol=5e-2),
       "int8": dict(rtol=0, atol=1e-3)}
F3_PATCHES = {"small": 10, "medium": 20, "large": 40}  # its third scale takes 56²


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def models(f1_checkpoint, tmp_path_factory):
    """family -> (config path, checkpoint path), each written by JAX."""
    from heuristique_style_transfer_code_tpu.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu.models.gram_attention import gram_attention_init
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import multiscale_init

    d = tmp_path_factory.mktemp("serve_models")
    out = {"truncated_resnet50": f1_checkpoint}
    cfg2 = str(d / "f2.json")
    with open(cfg2, "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "gram_matrix_size": 4,
                   "num_classes": 4, "seed": 0}, f)
    ck2 = str(d / "f2.npz")
    save_pytree_npz(gram_attention_init(jax.random.PRNGKey(0), 5, 4, 4), ck2)
    out["gram_attention"] = (cfg2, ck2)
    for norm in ("instance", "batch"):
        cfg3 = str(d / f"f3_{norm}.json")
        with open(cfg3, "w") as f:
            json.dump({"batch_size": 4, "lr": 0.01, "seed": 0, "num_classes": 4,
                       "patch_sizes": F3_PATCHES, "ndf": 8, "norm": norm}, f)
        ck3 = str(d / f"f3_{norm}.npz")
        save_pytree_npz(multiscale_init(jax.random.PRNGKey(1), F3_PATCHES, ndf=8,
                                        num_classes=4, norm=norm), ck3)
        out[f"multi_patchgan_{norm}"] = (cfg3, ck3)
    return out


def _family(key):
    return "multi_patchgan" if key.startswith("multi_patchgan") else key


def _argv(models, key, *extra):
    cfg, ckpt = models[key]
    return ["--family", _family(key), "--config_path", cfg, "--model_path", ckpt,
            "--batch_size", "2", *extra]


def _crop(key):
    return 224 if key.startswith("multi_patchgan") else CROP


def _frames(n, seed, crop=CROP):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (crop, crop, 3)).astype(np.uint8) for _ in range(n)]


@pytest.mark.parametrize("key", ["truncated_resnet50", "gram_attention",
                                 "multi_patchgan_instance", "multi_patchgan_batch"])
def test_build_forward_matches_jax(models, key):
    cfg, ckpt = models[key]
    x = np.random.RandomState(0).randn(2, _crop(key), _crop(key), 3).astype(np.float32)
    j_fwd, variables, j_config = jcli._build_forward(_family(key), cfg, ckpt)
    t_fwd, model, t_config = tcli._build_forward(_family(key), cfg, ckpt, "cpu")
    want = np.asarray(j_fwd(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = t_fwd(model, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4)
    np.testing.assert_allclose(got, want, **TOL["float32"])
    assert t_config == j_config


def _served(server, frames):
    with server:
        return np.stack([f.result(timeout=120) for f in [server.submit(x) for x in frames]])


CASES = [("truncated_resnet50", "float32", "rgb"), ("truncated_resnet50", "bf16", "rgb"),
         ("truncated_resnet50", "float32", "yuv420"), ("gram_attention", "float32", "rgb"),
         ("gram_attention", "bf16", "yuv420"), ("multi_patchgan_instance", "float32", "rgb"),
         ("multi_patchgan_instance", "bf16", "rgb"), ("truncated_resnet50", "int8", "rgb"),
         ("gram_attention", "int8", "rgb")]


@pytest.mark.parametrize("key,precision,transport", CASES,
                         ids=["-".join(c) for c in CASES])
def test_served_probabilities_match_jax(models, tiny_imagefolder, tmp_path, key, precision,
                                        transport):
    extra = ["--precision", precision, "--transport", transport]
    if precision == "int8":
        extra += ["--calib_data", str(tiny_imagefolder), "--quantized_path",
                  str(tmp_path / "q.npz")]
    argv = _argv(models, key, *extra)
    t_fwd, model, _, t_names = tcli._resolve_forward(
        tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    if precision == "int8":
        assert os.path.exists(tmp_path / "q.npz")  # the port calibrated and wrote it
    j_fwd, variables, _, j_names = jcli._resolve_forward(jcli.build_parser().parse_args(argv))
    assert t_names == j_names
    crop = _crop(key)
    frames = _frames(3, seed=1, crop=crop)  # a full batch and a padded one
    got = _served(BatchingInferenceServer(t_fwd, model, batch_size=2, max_delay_ms=5,
                                          crop=crop, transport=transport), frames)
    want = _served(JServer(j_fwd, variables, batch_size=2, max_delay_ms=5, crop=crop,
                           transport=transport), frames)
    assert got.shape == want.shape == (3, 4)
    np.testing.assert_allclose(got, want, **TOL[precision])
    if precision != "bf16":
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def test_int8_family3_refused_as_jax(models):
    argv = _argv(models, "multi_patchgan_instance", "--precision", "int8")
    with pytest.raises(ValueError) as want:
        jcli._resolve_forward(jcli.build_parser().parse_args(argv))
    with pytest.raises(ValueError) as got:
        tcli._resolve_forward(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert str(got.value) == str(want.value)
    assert "truncated_resnet50 and gram_attention" in str(got.value)


def test_int8_needs_calibration_data_as_jax(models):
    argv = _argv(models, "truncated_resnet50", "--precision", "int8")
    with pytest.raises(ValueError) as want:
        jcli._resolve_forward(jcli.build_parser().parse_args(argv))
    with pytest.raises(ValueError) as got:
        tcli._resolve_forward(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    assert str(got.value) == str(want.value)


def test_moco_only_checkpoint_raises_the_jax_key_error(tmp_path):
    from heuristique_style_transfer_code_tpu.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
        truncated_moco_init,
    )

    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "seed": 0, "dim": 16}, f)
    ckpt = str(tmp_path / "moco_only.npz")
    save_pytree_npz({"moco": truncated_moco_init(jax.random.PRNGKey(0), 5, dim=16)}, ckpt)
    with pytest.raises(KeyError) as want:
        jcli._build_forward("truncated_resnet50", cfg, ckpt)
    with pytest.raises(KeyError, match="classifier weights not found") as got:
        tcli._build_forward("truncated_resnet50", cfg, ckpt, "cpu")
    assert str(got.value) == str(want.value)


def _actions(parser):
    return {a.dest: a for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_parser_has_every_jax_flag_with_its_default_and_choices():
    want, got = _actions(jcli.build_parser()), _actions(tcli.build_parser())
    assert set(got) - set(want) == {"device"}
    assert set(want) <= set(got)
    for dest, a in want.items():
        b = got[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        assert b.choices == a.choices, dest
        assert b.nargs == a.nargs and b.type == a.type, dest
        assert type(b) is type(a), dest
    assert got["device"].default == "cuda"
    helps = " ".join(a.help or "" for a in got.values())
    assert "TPU" not in helps and "MB" not in helps and "2.2x" not in helps


@pytest.mark.parametrize("flag", [["--artifact", "a.npz", "--devices", "2"],
                                  ["--export_artifact", "a.npz", "--devices", "2"],
                                  ["--export_batch", "8", "--devices", "2"],
                                  ["--export_platforms", "cpu", "--devices", "2"],
                                  ["--devices", "2"]],
                         ids=lambda f: f[0])
def test_unported_flags_raise(models, flag):
    """``--devices`` is not ported, alone or with the artifact flags (a
    sharded artifact)."""
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tcli.main(_argv(models, "truncated_resnet50", "--device", "cpu", *flag))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tcli.start(tcli.build_parser().parse_args(
            _argv(models, "truncated_resnet50", "--device", "cpu", *flag)))


def test_device_cuda_raises_without_a_card(models):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    args = tcli.build_parser().parse_args(_argv(models, "truncated_resnet50", "--port", "0"))
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.start(args)


def test_start_serves_http_and_recycling_is_wired(models, monkeypatch, capsys):
    args = tcli.build_parser().parse_args(
        _argv(models, "truncated_resnet50", "--port", "0", "--device", "cpu",
              "--classes", "a", "b", "c", "d"))
    srv, batcher = tcli.start(args)
    try:
        host, port = srv.server_address
        conn = http.client.HTTPConnection(host, port, timeout=120)
        frame = np.random.RandomState(3).randint(0, 256, (224, 224, 3)).astype(np.uint8)
        conn.request("POST", "/predict", body=frame.tobytes(),
                     headers={"X-Raw-Shape": "224,224,3"})
        r = conn.getresponse()
        assert r.status == 200
        out = json.loads(r.read())
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.stop(drain=True)
    printed = capsys.readouterr().out
    assert "Warmup done in" in printed and "Serving truncated_resnet50 on http://" in printed
    assert stats["images"] == 2  # the warm frame and the request
    fwd, model, _, _ = tcli._resolve_forward(args)
    direct = _served(BatchingInferenceServer(fwd, model, batch_size=2, max_delay_ms=5),
                     [frame])[0]
    np.testing.assert_allclose(out["probs"], direct, rtol=1e-6, atol=1e-7)
    assert out["class"] == "abcd"[int(np.argmax(direct))]

    seen = {}

    class FakeProxy:
        info = {"class_names": ["a"], "served": "truncated_resnet50", "batch_size": 2,
                "device": "cpu", "crop": 224}
        crop = 224

        def __init__(self, builder, argv, **kw):
            seen.update(builder=builder, argv=argv, **kw)

        def start(self):
            return self

    from heuristique_style_transfer_code_tpu_torch.tasks import recycling

    monkeypatch.setattr(recycling, "RecyclingServiceProxy", FakeProxy)
    argv = _argv(models, "truncated_resnet50", "--port", "0", "--recycle_after_requests", "7")
    srv, proxy = tcli.start_recycling(tcli.build_parser().parse_args(argv), argv)
    srv.shutdown()
    srv.server_close()
    assert seen["builder"] == "heuristique_style_transfer_code_tpu_torch.cli.serve:_recycle_worker"
    assert "--recycle_after_requests" not in seen["argv"] and seen["recycle_after"] == 7
    assert seen["preprocess_factory"] is tcli._recycle_preprocess
    prep = tcli._recycle_preprocess({"crop": CROP})
    (prepared,), kw = prep(np.zeros((100, 80, 3), np.uint8))
    assert prepared.shape == (CROP, CROP, 3) and kw == {}
    with pytest.raises(ValueError, match="uint8"):
        prep(np.zeros((CROP, CROP, 3), np.float32))


def test_profile_dir_writes_a_trace(models, tmp_path):
    d = tmp_path / "trace"
    tcli.main(_argv(models, "truncated_resnet50", "--port", "0", "--device", "cpu",
                    "--max_seconds", "0", "--profile_dir", str(d)))
    assert any(name.endswith(".pt.trace.json") for name in os.listdir(d))


def test_sigterm_drains_and_exits(models):
    proc = subprocess.Popen(
        [sys.executable, "-m", "heuristique_style_transfer_code_tpu_torch.cli.serve",
         *_argv(models, "truncated_resnet50", "--port", "0", "--max_delay_ms", "5",
                "--device", "cpu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    captured, ready = [], threading.Event()

    def reader():
        for line in proc.stdout:
            captured.append(line)
            if line.startswith("Serving "):
                ready.set()
        ready.set()

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        assert ready.wait(timeout=120), "".join(captured)[-2000:]
        assert proc.poll() is None, "".join(captured)[-2000:]
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        t.join(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
    out = "".join(captured)
    assert proc.returncode == 0, out[-2000:]
    assert "SIGTERM: draining" in out and "Stats: 1 images in 1 batches" in out


@pytest.mark.parametrize("cli", ["serve", "serve_style", "test_gram_attention",
                                 "test_multi_patchgan", "test_truncated_resnet50",
                                 "train_gram_attention", "train_multi_patchgan",
                                 "train_style_net", "train_truncated_resnet50"])
def test_every_entry_point_defaults_to_cuda(cli):
    """The port's device rule on every CLI that runs a model: ``--device``
    defaults to ``cuda`` (``resolve_device`` then raises on a host without
    a card, never falling back to the CPU)."""
    import importlib

    from heuristique_style_transfer_code_tpu_torch.core.device import resolve_device

    parser = importlib.import_module(
        f"heuristique_style_transfer_code_tpu_torch.cli.{cli}").build_parser()
    assert _actions(parser)["device"].default == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(_actions(parser)["device"].default)
