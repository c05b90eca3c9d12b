"""The port's ``cli/train_style_net.py`` against the JAX CLI on the
``tiny_imagefolder`` fixture and a JAX-written truncate-6 family-2
encoder: the ``style_net.npz`` and hyperparameters it writes (the JAX
layout and keys, served by both packages' ``serve_style --net``), the
conditional gallery and ``--stylize_dir``, the interrupt-and-resume
contract (bit-identical to an uninterrupted run on the CPU, single and
multi-style, with ``--async_checkpoint`` too), the resume signature, the
schedule and clipping flags, and the flags that raise "not ported yet".

Size: 8 content images in batches of 4, 2 epochs, width 4, n_res 1, crop
32. The port's runs start from the port's seeded init, not JAX's, so the
two CLIs' nets are compared by layout, not by value."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.io import load_pytree_npz
from heuristique_style_transfer_code_tpu_torch.cli.train_style_net import main
from heuristique_style_transfer_code_tpu_torch.tasks import fast_style as pf
from heuristique_style_transfer_code_tpu_torch.train import preemption


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast alone and keeps the
    test workers that share the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def f2_encoder(tmp_path_factory):
    """A tiny family-2 encoder checkpoint (truncate 6) and its config,
    written by the JAX package."""
    from heuristique_style_transfer_code_tpu.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu.models.gram_attention import gram_attention_init

    d = tmp_path_factory.mktemp("f2enc6")
    cfg_path = str(d / "f2.json")
    with open(cfg_path, "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 6, "gram_matrix_size": 4,
                   "num_classes": 4, "seed": 0}, f)
    model_path = str(d / "model.npz")
    save_pytree_npz(gram_attention_init(jax.random.PRNGKey(0), 6, 4, 4), model_path)
    return cfg_path, model_path


def _style(folder, cls="fog"):
    return str(next((folder / "test" / cls).glob("*.png")))


def _args(folder, f2_encoder, save_dir, *styles, extra=(), epochs=2):
    cfg_path, model_path = f2_encoder
    flags = []
    for s in styles:
        flags += ["--style_image", s]
    return ["--data", str(folder), *flags, "--config_path", cfg_path,
            "--model_path", model_path, "--epochs", str(epochs), "--batch_size", "4",
            "--num_samples", "8", "--width", "4", "--n_res", "1", "--crop", "32",
            "--log_every", "1", "--save_dir", str(save_dir), "--seed", "0", *extra]


def _leaves(path):
    return jax.tree_util.tree_leaves(load_pytree_npz(path))


def _shapes(tree):
    return {jax.tree_util.keystr(k): np.shape(v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_net_file_matches_jax_and_serves_in_both_packages(tiny_imagefolder, f2_encoder,
                                                           tmp_path):
    from heuristique_style_transfer_code_tpu.cli import serve_style as j_serve
    from heuristique_style_transfer_code_tpu.cli.train_style_net import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli import serve_style as p_serve

    style = _style(tiny_imagefolder)
    j_main(_args(tiny_imagefolder, f2_encoder, tmp_path / "jax", style, epochs=1,
                 extra=("--devices", "1")))
    main(_args(tiny_imagefolder, f2_encoder, tmp_path / "port", style, epochs=1,
               extra=("--device", "cpu", "--afficher_params")))
    net_path = str(tmp_path / "port" / "style_net.npz")
    assert _shapes(load_pytree_npz(net_path)) == _shapes(
        load_pytree_npz(str(tmp_path / "jax" / "style_net.npz")))
    hyper = {}
    for side in ("jax", "port"):
        with open(tmp_path / side / "style_net_hyperparameters.json") as f:
            hyper[side] = json.load(f)
    assert set(hyper["port"]) == set(hyper["jax"])
    final = [hyper[side].pop("final_loss") for side in ("jax", "port")]
    assert hyper["port"] == hyper["jax"] and np.isfinite(final).all()
    assert pf.net_from_tree(load_pytree_npz(net_path), "cpu").in1.weight.shape == (4,)

    img = np.random.RandomState(4).randint(0, 256, (40, 40, 3)).astype(np.uint8)
    name = os.path.splitext(os.path.basename(style))[0]
    for cli, extra in ((j_serve, []), (p_serve, ["--device", "cpu"])):
        args = cli.build_parser().parse_args(["--net", net_path, "--batch_size", "2",
                                              "--max_delay_ms", "20", *extra])
        svc = cli.build_service(args).start()
        try:
            assert svc.style_names == [name]
            r = svc.submit(img, style=name).result(timeout=120)
            assert np.asarray(r.image).shape == (32, 32, 3) and r.iterations == 1
        finally:
            svc.stop()


def test_gallery_writes_a_conditional_net_and_stylised_pngs(tiny_imagefolder, f2_encoder,
                                                            tmp_path):
    from heuristique_style_transfer_code_tpu_torch.utils.png import decode_png

    styles = [f"fog={_style(tiny_imagefolder)}", f"rain={_style(tiny_imagefolder, 'rain')}"]
    out = tmp_path / "samples"
    main(_args(tiny_imagefolder, f2_encoder, tmp_path / "net", *styles, epochs=1,
               extra=("--device", "cpu", "--stylize_dir", str(out),
                      "--style_sampling", "uniform")))
    with open(tmp_path / "net" / "style_net_hyperparameters.json") as f:
        hyper = json.load(f)
    assert hyper["style_names"] == ["fog", "rain"]
    net = pf.net_from_tree(load_pytree_npz(str(tmp_path / "net" / "style_net.npz")), "cpu")
    assert net.in1.weight.shape == (2, 4)
    for name in ("fog", "rain"):
        for i in range(4):
            with open(out / f"stylise_{name}_{i}.png", "rb") as f:
                assert decode_png(f.read()).shape[:2] == (32, 64)  # [original | stylised]


def _preempt_after(monkeypatch, n):
    calls = {"n": 0}

    def fake():
        calls["n"] += 1
        return calls["n"] > n

    monkeypatch.setattr(preemption, "preemption_requested", fake)


@pytest.mark.parametrize("variant", ["single", "multi", "async"])
def test_interrupt_and_resume_bit_identical(tiny_imagefolder, f2_encoder, tmp_path,
                                            monkeypatch, variant):
    """Preempted at the 4th batch boundary (mid epoch 2, after
    step-granular checkpoints), then resumed by the same command: the
    final net and loss equal an uninterrupted run's bit for bit."""
    styles = [_style(tiny_imagefolder)]
    if variant == "multi":
        styles = [f"fog={styles[0]}", f"rain={_style(tiny_imagefolder, 'rain')}"]
    main(_args(tiny_imagefolder, f2_encoder, tmp_path / "a", *styles, extra=("--device", "cpu")))
    extra = ("--device", "cpu", "--resume", "--checkpoint_every", "1")
    if variant == "async":
        extra += ("--async_checkpoint",)
    args_b = _args(tiny_imagefolder, f2_encoder, tmp_path / "b", *styles, extra=extra)
    _preempt_after(monkeypatch, 3)
    main(args_b)
    assert not (tmp_path / "b" / "style_net.npz").exists()
    assert (tmp_path / "b" / pf._INPROGRESS_NET).exists()
    monkeypatch.undo()
    main(args_b)
    assert not (tmp_path / "b" / pf._INPROGRESS_NET).exists()
    la, lb = _leaves(str(tmp_path / "a" / "style_net.npz")), _leaves(
        str(tmp_path / "b" / "style_net.npz"))
    assert len(la) == len(lb) == 30
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    losses = []
    for side in ("a", "b"):
        with open(tmp_path / side / "style_net_hyperparameters.json") as f:
            losses.append(json.load(f)["final_loss"])
    assert losses[0] == losses[1]


@pytest.mark.parametrize("change", [("--style_weight", "2.0"), ("--layers", "5")])
def test_resume_under_another_configuration_is_refused(tiny_imagefolder, f2_encoder, tmp_path,
                                                       monkeypatch, change):
    d = tmp_path / "s"
    style = _style(tiny_imagefolder)
    _preempt_after(monkeypatch, 1)
    main(_args(tiny_imagefolder, f2_encoder, d, style,
               extra=("--device", "cpu", "--resume", "--checkpoint_every", "1")))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="does not match"):
        main(_args(tiny_imagefolder, f2_encoder, d, style,
                   extra=("--device", "cpu", "--resume", *change)))


def test_schedule_and_clip_change_the_fit(tiny_imagefolder, f2_encoder, tmp_path, capsys):
    style = _style(tiny_imagefolder)
    main(_args(tiny_imagefolder, f2_encoder, tmp_path / "const", style,
               extra=("--device", "cpu")))
    main(_args(tiny_imagefolder, f2_encoder, tmp_path / "sched", style,
               extra=("--device", "cpu", "--lr_schedule", "cosine", "--warmup_steps", "2",
                      "--min_lr_ratio", "0.1", "--clip_grad_norm", "1.0")))
    assert "lr schedule: cosine, warmup 2 steps, horizon 4 steps" in capsys.readouterr().out
    diffs = [np.abs(x - y).max() for x, y in zip(
        _leaves(str(tmp_path / "const" / "style_net.npz")),
        _leaves(str(tmp_path / "sched" / "style_net.npz")))]
    assert np.isfinite(diffs).all() and max(diffs) > 0.0
    with open(tmp_path / "sched" / "style_net_hyperparameters.json") as f:
        assert np.isfinite(json.load(f)["final_loss"])


@pytest.mark.parametrize("extra", [("--devices", "2"), ("--profile_dir", "p"),
                                   ("--debug_nans",)])
def test_unported_flags_raise(tiny_imagefolder, f2_encoder, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(_args(tiny_imagefolder, f2_encoder, tmp_path, _style(tiny_imagefolder),
                   extra=("--device", "cpu", *extra)))


def test_odd_crop_is_refused(tiny_imagefolder, f2_encoder, tmp_path):
    with pytest.raises(SystemExit):
        main(_args(tiny_imagefolder, f2_encoder, tmp_path, _style(tiny_imagefolder),
                   extra=("--device", "cpu", "--crop", "30")))


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(tiny_imagefolder, f2_encoder,
                                                                tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_args(tiny_imagefolder, f2_encoder, tmp_path, _style(tiny_imagefolder)))
