"""The port's family-2 evaluation CLI against the JAX CLI on the
``tiny_imagefolder`` fixture, its device rule, its "not ported yet" errors,
and the rule that the port imports neither JAX nor the JAX package."""
import ast
import json
import os

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "heuristique_style_transfer_code_tpu_torch")


@pytest.fixture(scope="module")
def f2_model(tmp_path_factory):
    """A tiny family-2 checkpoint (truncate 5, S 4) written by the port's
    npz writer from seeded weights, which both CLIs read, and its config."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )

    d = tmp_path_factory.mktemp("f2torch")
    ckpt = str(d / "model.npz")
    model = gram_attention_init(torch.Generator().manual_seed(0), 5, 4, 4, device="cpu")
    save_pytree_npz(to_jax_tree(model), ckpt)
    cfg = str(d / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 5,
                   "gram_matrix_size": 4, "num_classes": 4, "seed": 0}, f)
    return cfg, ckpt


def _args(data, f2_model, save_dir, *extra):
    cfg, ckpt = f2_model
    return ["--data", str(data), "--config_path", cfg, "--model_path", ckpt,
            "--save_dir", str(save_dir), *extra]


def test_classification_results_equal_jax_cli(tiny_imagefolder, f2_model, tmp_path):
    from heuristique_style_transfer_code_tpu.cli.test_gram_attention import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    flags = ["--mode", "classification", "--compute_auc"]
    j_main(_args(tiny_imagefolder, f2_model, tmp_path / "jax", *flags))
    main(_args(tiny_imagefolder, f2_model, tmp_path / "torch", *flags, "--device", "cpu"))
    results = []
    for side in ("jax", "torch"):
        with open(tmp_path / side / "classification_results.json") as f:
            results.append(json.load(f))
    assert set(results[1]) == {"precision", "recall", "f1_score", "auc"}
    assert results[1] == results[0]


def test_style_transfer_writes_png_tree(tiny_imagefolder, f2_model, tmp_path):
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    main(_args(tiny_imagefolder, f2_model, tmp_path, "--mode", "style_transfer",
               "--layers", "5", "--num_iterations", "2", "--num_samples", "3",
               "--batch_size", "2", "--device", "cpu"))
    (st,) = [d for d in os.listdir(tmp_path) if d.startswith("style_transfer_")]
    pngs = sorted(os.path.join(dp, f) for dp, _, fs in os.walk(tmp_path / st) for f in fs)
    assert sorted(os.path.basename(p) for p in pngs) == [
        f"style_transfer_{i}.png" for i in range(3)]
    for p in pngs:  # <label>/style_transfer_<i>.png, [original | stylised]
        assert os.path.basename(os.path.dirname(p)) in {"0", "1", "2", "3"}
        with Image.open(p) as im:  # RGBA with an opaque alpha, as matplotlib's imsave writes
            assert im.size == (448, 224) and im.mode == "RGBA"
            assert (np.asarray(im)[..., 3] == 255).all()


@pytest.mark.parametrize("mode,png", [("tsne", "tsne_visualization.png"),
                                      ("tsne_interactive", "tsne_plot.png")])
def test_tsne_modes_write_the_jax_artifacts(tiny_imagefolder, f2_model, tmp_path, monkeypatch,
                                            mode, png):
    """The family-2 t-SNE file name; without a display the interactive
    mode falls back to the static plot, whose default name it keeps."""
    from heuristique_style_transfer_code_tpu.cli.test_gram_attention import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    from threadpoolctl import threadpool_limits

    monkeypatch.delenv("DISPLAY", raising=False)
    flags = ["--mode", mode, "--num_samples", "8"]
    # t-SNE's OpenMP team per call, beside the other test workers,
    # oversubscribes the host's cores: one thread keeps it quick
    with threadpool_limits(limits=1, user_api="openmp"):
        j_main(_args(tiny_imagefolder, f2_model, tmp_path / "jax", *flags))
        main(_args(tiny_imagefolder, f2_model, tmp_path / "torch", *flags, "--device", "cpu"))
    for side in ("jax", "torch"):
        assert os.listdir(tmp_path / side) == [png]
        assert os.path.getsize(tmp_path / side / png) > 0


def test_camera_on_a_video_file_matches_jax_cli(tiny_imagefolder, f2_model, tmp_path):
    import cv2

    from heuristique_style_transfer_code_tpu.cli.test_gram_attention import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    video = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rng = np.random.RandomState(0)
    for _ in range(3):
        w.write(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8))
    w.release()
    flags = ["--mode", "camera", "--camera_index", video, "--measure_time", "--classes", "fog",
             "rain", "snow", "sun"]
    j_main(_args(tiny_imagefolder, f2_model, tmp_path / "jax", *flags))
    main(_args(tiny_imagefolder, f2_model, tmp_path / "torch", *flags, "--device", "cpu"))
    for side in ("jax", "torch"):
        with open(tmp_path / side / "times_camera.json") as f:
            assert len(json.load(f)) == 3


def test_camera_without_classes_keeps_the_jax_message(tiny_imagefolder, f2_model, tmp_path):
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    with pytest.raises(ValueError, match="specify classes with the --classes option"):
        main(_args(tiny_imagefolder, f2_model, tmp_path, "--mode", "camera", "--device", "cpu"))


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(tiny_imagefolder, f2_model,
                                                               tmp_path):
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_args(tiny_imagefolder, f2_model, tmp_path, "--mode", "classification"))


@pytest.mark.parametrize("extra", [
    ["--shard_spatial", "2"], ["--devices", "2"],
])
def test_unported_modes_and_flags_raise(tiny_imagefolder, f2_model, tmp_path, capsys, extra):
    """Both flags are ported (the ranks' runs are
    ``tests/test_torch_eval_devices.py`` and ``tests/test_torch_spatial.py``).
    ``--shard_spatial`` acts in style transfer alone, as in the JAX CLI:
    classification ignores it, no process started. ``--devices`` at
    ``--batch_size 1``: JAX's clamp to the largest count dividing the batch
    leaves 1 device, the clamp printed and no process started. Either way
    the classification results are the plain run's byte for byte."""
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    runs = {}
    for tag, flags in (("one", []), ("flagged", extra)):
        out = tmp_path / tag
        main(_args(tiny_imagefolder, f2_model, out, "--mode", "classification", "--batch_size",
                   "1", "--num_samples", "3", *flags, "--device", "cpu"))
        runs[tag] = (out / "classification_results.json").read_bytes()
    printed = capsys.readouterr().out
    if "--devices" in extra:
        assert "--devices 2: using 1 device(s)" in printed
    assert "ranks (gloo)" not in printed
    assert runs["flagged"] == runs["one"]


def _png_pixels(root):
    from PIL import Image

    out = {}
    for dp, _, fs in os.walk(root):
        for f in fs:
            if f.endswith(".png"):
                with Image.open(os.path.join(dp, f)) as im:
                    out[f] = np.asarray(im)
    return out


@pytest.mark.parametrize("flag", ["--remat", "--steps_per_dispatch"])
def test_remat_and_steps_per_dispatch_keep_the_results(tiny_imagefolder, f2_model, tmp_path,
                                                        flag):
    """``--remat`` on ``--mode style_transfer`` gives the plain run's PNGs
    bit for bit on the CPU (the same ops, the blocks run again in the
    backward); ``--steps_per_dispatch 2`` on ``--mode classification``
    (12 images in b4: a chunk of 2, a tail of 1) the plain run's
    ``classification_results.json`` byte for byte."""
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    if flag == "--remat":
        flags, extra = ["--mode", "style_transfer", "--layers", "5", "--num_iterations", "2",
                        "--num_samples", "2", "--batch_size", "2"], [flag]
    else:
        flags, extra = ["--mode", "classification"], [flag, "2"]
    main(_args(tiny_imagefolder, f2_model, tmp_path / "plain", *flags, "--device", "cpu"))
    main(_args(tiny_imagefolder, f2_model, tmp_path / "flag", *flags, *extra, "--device", "cpu"))
    if flag == "--remat":
        plain, got = _png_pixels(tmp_path / "plain"), _png_pixels(tmp_path / "flag")
        assert sorted(got) == sorted(plain) and len(got) == 2
        assert all(np.array_equal(got[k], plain[k]) for k in plain)
    else:
        with open(tmp_path / "plain" / "classification_results.json", "rb") as f, \
                open(tmp_path / "flag" / "classification_results.json", "rb") as g:
            assert f.read() == g.read()


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dp, dirs, fs in os.walk(PORT):
        dirs[:] = [d for d in dirs if d != "_build"]  # build outputs, not the package's source
        files += [os.path.join(dp, f) for f in fs if f.endswith(".py")]
    assert len(files) > 20
    for module in ("checkpoint/pth_converter.py", "checkpoint/pth_exporter.py",
                   "cli/convert_checkpoint.py", "tasks/style_transfer.py",
                   "ops/kernels/instance_norm.py", "data/augment.py",
                   "cli/train_truncated_resnet50.py", "cli/train_multi_patchgan.py",
                   "tasks/serving.py", "tasks/serving_http.py", "cli/serve.py",
                   "tasks/recycling.py", "deploy/artifact.py", "native/__init__.py",
                   "parallel/__init__.py", "parallel/foldparallel.py", "core/mesh.py",
                   "parallel/multihost.py", "parallel/sharding.py",
                   "parallel/tensor_parallel.py", "checkpoint/sharded_io.py",
                   "checkpoint/async_io.py", "data/loader.py"):
        assert os.path.join(PORT, module) in files, module
    bad = []
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "flax", "optax") or top == "heuristique_style_transfer_code_tpu":
                bad.append((os.path.relpath(path, REPO), name))
    assert not bad, bad


@pytest.mark.parametrize("case", ["classification", "qat", "tsne", "style_transfer"])
def test_precision_int8_runs(tiny_imagefolder, f2_model, tmp_path, capsys, case):
    """``--precision int8`` (calibrated on ``--data``'s train/ split):
    classification writes ``--quantized_path``, a second run loads it and
    writes the same ``classification_results.json``, which the JAX CLI on
    the port's file writes too; ``--qat_steps 2`` prints JAX's fine-tune
    line; ``--mode tsne`` runs on the int8 encoder; a mode outside
    classification and t-SNE keeps the JAX CLI's ValueError."""
    from heuristique_style_transfer_code_tpu.cli.test_gram_attention import main as j_main
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import main

    q = str(tmp_path / "q.npz")
    flags = ["--precision", "int8", "--device", "cpu"]
    if case == "style_transfer":
        with pytest.raises(ValueError, match="classification/tsne/tsne_interactive"):
            main(_args(tiny_imagefolder, f2_model, tmp_path, "--mode", case, *flags))
        return
    if case == "tsne":
        from threadpoolctl import threadpool_limits

        with threadpool_limits(limits=1, user_api="openmp"):
            main(_args(tiny_imagefolder, f2_model, tmp_path, "--mode", "tsne", "--num_samples",
                       "8", *flags))
        assert os.listdir(tmp_path) == ["tsne_visualization.png"]
        return
    extra = ["--qat_steps", "2"] if case == "qat" else []
    main(_args(tiny_imagefolder, f2_model, tmp_path / "a", "--quantized_path", q, *flags,
               *extra))
    printed = capsys.readouterr().out
    assert f"Quantised encoder saved to {q}" in printed
    assert ("QAT fine-tune: 2 pas, perte" in printed) == (case == "qat")
    if case == "qat":
        return
    main(_args(tiny_imagefolder, f2_model, tmp_path / "b", "--quantized_path", q, *flags))
    j_main(_args(tiny_imagefolder, f2_model, tmp_path / "jax", "--quantized_path", q,
                 "--precision", "int8"))
    results = []
    for side in ("a", "b", "jax"):
        with open(tmp_path / side / "classification_results.json") as f:
            results.append(json.load(f))
    assert results[0] == results[1] == results[2]
