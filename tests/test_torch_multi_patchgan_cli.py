"""The port's family-3 evaluation CLI against the JAX CLI on the
``tiny_imagefolder`` fixture and a small family-3 checkpoint (ndf 8, gram
dim 8, the default patch sizes, 4 classes), written by the port's npz
writer from seeded weights; both CLIs read it. The 224² crops of the
staged images are above the 192² that ndf 8 needs.

Tolerances: ``classification_results.json``'s accuracy, precision,
recall, F1, predictions and labels equal (the same predictions); the
AUC within 1e-6 (the same probabilities to about 1e-7); the embeddings of
the t-SNE modes are held in ``test_torch_embeddings.py``."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from heuristique_style_transfer_code_tpu.cli.test_multi_patchgan import main as j_main
from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import build_parser, main

N_TEST, BATCH = 12, 4


@pytest.fixture(autouse=True)
def _headless(monkeypatch):
    monkeypatch.delenv("DISPLAY", raising=False)


@pytest.fixture(autouse=True)
def _one_thread_for_openmp():
    """t-SNE and HDBSCAN start an OpenMP team on every call; beside the
    other test workers those teams oversubscribe the host's cores and a
    t-SNE of 20 points slows a hundredfold. One thread keeps them quick
    (and both packages' runs in one process still see the same setting)."""
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="openmp"):
        yield


@pytest.fixture(scope="module")
def f3_model(tmp_path_factory):
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )

    d = tmp_path_factory.mktemp("f3torch")
    model = multiscale_test_init(torch.Generator().manual_seed(0),
                                 {"small": 10, "medium": 70, "large": 150}, ndf=8,
                                 num_classes=4, gram_matrix_dim=8, norm="batch", device="cpu")
    ckpt = str(d / "model.npz")
    save_pytree_npz(to_jax_tree(model), ckpt)
    cfg = str(d / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"batch_size": BATCH, "seed": 0, "ndf": 8, "gram_matrix_dim": 8,
                   "num_classes": 4, "norm": "batch"}, f)
    return cfg, ckpt


def _args(data, f3_model, save_dir, *extra):
    cfg, ckpt = f3_model
    return ["--data", str(data), "--config_path", cfg, "--model_path", ckpt,
            "--save_dir", str(save_dir), *extra]


def _both(data, f3_model, tmp_path, *flags):
    j_main(_args(data, f3_model, tmp_path / "jax", *flags))
    main(_args(data, f3_model, tmp_path / "torch", *flags, "--device", "cpu"))
    return tmp_path / "jax", tmp_path / "torch"


def _load(path):
    with open(path) as f:
        return json.load(f)


def test_classification_results_equal_jax_cli(tiny_imagefolder, f3_model, tmp_path, capsys):
    j_dir, t_dir = _both(tiny_imagefolder, f3_model, tmp_path, "--mode", "classification",
                         "--compute_auc", "--measure_time", "--afficher_params")
    j, t = (_load(d / "classification_results.json") for d in (j_dir, t_dir))
    assert list(t) == list(j) == ["accuracy", "precision", "recall", "f1_score", "predictions",
                                  "labels", "auc"]
    for key in ("accuracy", "precision", "recall", "f1_score", "predictions", "labels"):
        assert t[key] == j[key], key
    assert len(t["predictions"]) == N_TEST
    np.testing.assert_allclose(t["auc"], j["auc"], rtol=1e-6)
    assert os.path.getsize(t_dir / "confusion_matrix.png") > 0
    out = capsys.readouterr().out.splitlines()
    params = [line for line in out if line.startswith("Nombre total de paramètres")]
    assert len(params) == 2 and params[0] == params[1]
    assert sum(line.startswith("Temps moyen par image") for line in out) == 2


@pytest.mark.parametrize("mode", ["tsne", "tsne_interactive"])
def test_tsne_modes_write_the_jax_artifact(tiny_imagefolder, f3_model, tmp_path, mode):
    j_dir, t_dir = _both(tiny_imagefolder, f3_model, tmp_path, "--mode", mode,
                         "--num_samples", "8")
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir)) == ["tsne_plot.png"]
    assert os.path.getsize(t_dir / "tsne_plot.png") > 0


def test_camera_on_a_video_file_matches_jax_cli(tiny_imagefolder, f3_model, tmp_path):
    import cv2

    video = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rng = np.random.RandomState(0)
    for _ in range(3):
        w.write(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8))
    w.release()
    j_dir, t_dir = _both(tiny_imagefolder, f3_model, tmp_path, "--mode", "camera",
                         "--camera_index", video, "--measure_time", "--classes", "fog", "rain",
                         "snow", "sun")
    assert [len(_load(d / "times_camera.json")) for d in (j_dir, t_dir)] == [3, 3]


def test_camera_without_classes_keeps_the_jax_message(tiny_imagefolder, f3_model, tmp_path):
    with pytest.raises(ValueError, match="spécifier les classes avec l'option --classes"):
        main(_args(tiny_imagefolder, f3_model, tmp_path, "--mode", "camera", "--device", "cpu"))


def test_parser_has_every_jax_flag():
    from heuristique_style_transfer_code_tpu.cli.test_multi_patchgan import (
        build_parser as j_parser,
    )

    def flags(parser):
        return {a.option_strings[0]: (a.default, a.choices) for a in parser._actions
                if a.option_strings and a.dest != "help"}

    want, got = flags(j_parser()), flags(build_parser())
    assert set(got) - set(want) == {"--device"}
    assert {k: got[k] for k in want} == want


def test_precision_int8_is_refused_as_by_the_jax_parser(tiny_imagefolder, f3_model, tmp_path):
    """The family-3 JAX CLI offers float32 and bf16 only; so does the port."""
    with pytest.raises(SystemExit):
        build_parser().parse_args(_args(tiny_imagefolder, f3_model, tmp_path,
                                        "--precision", "int8"))


@pytest.mark.parametrize("extra", [
    ["--mode", "style_transfer", "--shard_spatial", "2"], ["--devices", "2"],
    ["--shard_spatial", "2"],
])
def test_unported_modes_and_flags_raise(tiny_imagefolder, f3_model, tmp_path, capfd, extra):
    """Both flags are ported. ``--shard_spatial 2`` in style transfer starts
    two gloo processes, each holding a band of every canvas's rows, and
    rank 0 writes the one-device run's PNGs (one image, 2 iterations),
    each once, within one uint8 level; in classification it is ignored, as
    by the JAX CLI. ``--devices 2 --device cpu`` starts two gloo processes
    (``parallel/multihost.launch``), each decoding and classifying its rows
    of every batch, and rank 0 writes the ``--devices 1`` run's
    classification_results.json, byte for byte, and its confusion matrix,
    each once."""
    if "style_transfer" in extra:
        loop = ("--num_samples", "1", "--num_iterations", "2", "--threshold", "0")
        pngs = {}
        for tag, flags in (("one", ["--mode", "style_transfer"]), ("two", extra)):
            out = tmp_path / tag
            main(_args(tiny_imagefolder, f3_model, out, *flags, *loop, "--device", "cpu"))
            pngs[tag] = {os.path.relpath(os.path.join(d, f), out).rsplit("_", 1)[0]:
                         np.asarray(Image.open(os.path.join(d, f)), np.int16)
                         for d, _, fs in os.walk(out) for f in fs if f.endswith(".png")}
        assert "Spatial sharding: 2 ranks (gloo), data 1 x spatial 2" in capfd.readouterr().out
        assert sorted(pngs["two"]) == sorted(pngs["one"]) and pngs["one"]
        for name, img in pngs["one"].items():
            assert np.abs(pngs["two"][name] - img).max() <= 1, name
        return
    runs = {}
    for tag, flags in (("one", []), ("two", extra)):
        out = tmp_path / tag
        main(_args(tiny_imagefolder, f3_model, out, "--mode", "classification", *flags,
                   "--device", "cpu"))
        runs[tag] = sorted(os.listdir(out)), (out / "classification_results.json").read_bytes()
    printed = capfd.readouterr().out
    ranks = "Data-parallel evaluation: 2 ranks (gloo), 2 images a rank per batch" in printed
    assert ranks == ("--devices" in extra)  # classification ignores --shard_spatial
    assert printed.count("Résultats de classification sauvegardés") == 2  # one a run
    assert runs["two"] == runs["one"]


@pytest.mark.parametrize("extra", [
    ["--steps_per_dispatch", "2"],
    ["--profile_dir", "PROFILE"],
    ["--debug_nans"],
])
def test_ported_runtime_flags_keep_the_results(tiny_imagefolder, f3_model, tmp_path, extra):
    """``--steps_per_dispatch 2`` (3 batches: a chunk of 2, a tail of 1),
    ``--profile_dir`` and ``--debug_nans`` on a clean model: the
    classification results of the plain run, byte for byte; the profile's
    Chrome trace is in its directory."""
    extra = [str(tmp_path / "prof") if e == "PROFILE" else e for e in extra]
    flags = ("--mode", "classification", "--device", "cpu")
    main(_args(tiny_imagefolder, f3_model, tmp_path / "plain", *flags))
    main(_args(tiny_imagefolder, f3_model, tmp_path / "flag", *flags, *extra))
    with open(tmp_path / "plain" / "classification_results.json", "rb") as f, \
            open(tmp_path / "flag" / "classification_results.json", "rb") as g:
        assert f.read() == g.read()
    if "--profile_dir" in extra:
        assert any(n.endswith(".pt.trace.json") for n in os.listdir(tmp_path / "prof"))


def test_steps_per_dispatch_with_measure_time_keeps_the_jax_exit(tiny_imagefolder, f3_model,
                                                                  tmp_path):
    flags = ("--mode", "classification", "--steps_per_dispatch", "2", "--measure_time")
    with pytest.raises(SystemExit) as jax_exit:
        j_main(_args(tiny_imagefolder, f3_model, tmp_path / "jax", *flags))
    with pytest.raises(SystemExit) as port_exit:
        main(_args(tiny_imagefolder, f3_model, tmp_path / "torch", *flags, "--device", "cpu"))
    assert str(port_exit.value) == str(jax_exit.value)


def test_train_variant_checkpoint_raises(tiny_imagefolder, f3_model, tmp_path, capsys):
    """A train-variant tree no longer raises: it loads partially into the
    test architecture, as the JAX CLI loads it (``shape_filtered_update``;
    this tree shares no path with the test variant, so nothing matches and
    the seeded init stays), and the CLI runs."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
        load_pytree_npz,
        save_pytree_npz,
    )

    cfg, ckpt = f3_model
    tree = load_pytree_npz(ckpt)
    train = {s: {"convs": [], "final": None, "out_conv": tree[s]["classifier"]}
             for s in ("small", "medium", "large")}
    bad = str(tmp_path / "train_variant.npz")
    save_pytree_npz(train, bad)
    main(["--data", str(tiny_imagefolder), "--config_path", cfg, "--model_path", bad,
          "--save_dir", str(tmp_path), "--device", "cpu"])
    assert "shape-filtered partial load into the test architecture (0/" in capsys.readouterr().out
    assert os.path.exists(tmp_path / "classification_results.json")


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(tiny_imagefolder, f3_model,
                                                              tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_args(tiny_imagefolder, f3_model, tmp_path, "--mode", "classification"))


def test_confusion_matrix_follows_scikit_learn():
    from sklearn.metrics import confusion_matrix

    from heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan import (
        confusion_matrix_of,
    )

    rng = np.random.RandomState(7)
    for _ in range(20):
        labels = rng.randint(0, 4, 30)
        preds = rng.choice(rng.permutation(4)[:2], 30)
        np.testing.assert_array_equal(confusion_matrix_of(labels, preds),
                                      confusion_matrix(labels, preds))


def test_weighted_auc_branches_differ_as_in_jax():
    """A 4-class model on labels that cover 2 classes: the labels branch
    takes the binary AUC of probs[:, 1], the probs branch stays multiclass
    and gives None; both as the JAX helper gives them."""
    from heuristique_style_transfer_code_tpu.cli._common import weighted_auc_or_none as j_auc
    from heuristique_style_transfer_code_tpu_torch.cli._common import weighted_auc_or_none

    rng = np.random.RandomState(8)
    probs = rng.dirichlet(np.ones(4), 20)
    two = np.array([0, 1] * 10)
    four = np.arange(20) % 4
    by_labels = weighted_auc_or_none(two, probs)
    assert by_labels is not None and by_labels == j_auc(two, probs)
    assert weighted_auc_or_none(two, probs, branch_on="labels") == by_labels
    assert weighted_auc_or_none(two, probs, branch_on="probs") is None
    assert j_auc(two, probs, branch_on="probs") is None
    for branch in ("labels", "probs"):
        got = weighted_auc_or_none(four, probs, branch_on=branch)
        assert got is not None and got == j_auc(four, probs, branch_on=branch)
