"""The port's family-1 evaluation CLI against the JAX CLI on the
``tiny_imagefolder`` and ``f1_checkpoint`` fixtures (truncate 5, dim 16,
4 classes, 12 test images in batches of 4).

Tolerances: accuracy, precision, recall, F1 and the confusion matrix equal
(the same predictions); the loss and the AUC within 1e-5 relative (another
summation order); inference probabilities within 1e-5. At the default
threshold 0.5 the seeded model's top probability never reaches it, so
every prediction is "Unknown"; threshold 0.0 makes the metrics count."""
import json
import os
import re

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.cli.test_truncated_resnet50 import main as j_main
from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import main

N_TEST, BATCH = 12, 4


def _args(data, f1_checkpoint, save_dir, *extra):
    cfg, ckpt = f1_checkpoint
    return ["--data", str(data), "--config_path", cfg, "--model_path", ckpt,
            "--save_dir", str(save_dir), "--batch_size", str(BATCH), *extra]


def _both(data, f1_checkpoint, tmp_path, *flags):
    j_main(_args(data, f1_checkpoint, tmp_path / "jax", *flags))
    main(_args(data, f1_checkpoint, tmp_path / "torch", *flags, "--device", "cpu"))
    return tmp_path / "jax", tmp_path / "torch"


def _metrics(path):
    """metrics.txt -> ({label: text}, confusion-matrix text)."""
    with open(path / "metrics.txt", encoding="utf-8") as f:
        head, cm = f.read().split("Matrice de confusion:\n")
    return dict(line.split(": ", 1) for line in head.splitlines()), cm


@pytest.mark.parametrize("threshold", ["0.5", "0.0"])
def test_classification_artifacts_equal_jax_cli(tiny_imagefolder, f1_checkpoint, tmp_path,
                                                threshold):
    j_dir, t_dir = _both(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "classification",
                         "--prob_threshold", threshold, "--compute_auc", "--measure_time")
    (j_lines, j_cm), (t_lines, t_cm) = _metrics(j_dir), _metrics(t_dir)
    assert list(t_lines) == list(j_lines) == [
        "Précision du test", "Perte du test", "Précision", "Rappel", "Score F1", "Score AUC"]
    for key in ("Précision du test", "Précision", "Rappel", "Score F1"):
        assert t_lines[key] == j_lines[key], key
    assert t_cm == j_cm
    for key in ("Perte du test", "Score AUC"):
        np.testing.assert_allclose(float(t_lines[key]), float(j_lines[key]), rtol=1e-5)
    with open(t_dir / "auc_score.txt") as f:
        np.testing.assert_allclose(float(f.read().split(": ")[1]), float(j_lines["Score AUC"]),
                                   rtol=1e-5)
    with open(t_dir / "times_test.json") as f:
        times = json.load(f)
    assert len(times) == N_TEST // BATCH and all(t > 0 for t in times)
    assert os.path.getsize(t_dir / "confusion_matrix.png") > 0
    if threshold == "0.5":  # every prediction Unknown: the reference's zeros
        assert t_lines["Précision"] == "0" and "[[0 0 0 0]" in t_cm
    else:
        assert int(np.array(t_cm.replace("[", " ").replace("]", " ").split(), int).sum()) == N_TEST


def test_classification_png_tree(tiny_imagefolder, f1_checkpoint, tmp_path):
    from PIL import Image

    main(_args(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "classification",
               "--prob_threshold", "0.0", "--save_test_images", "--device", "cpu"))
    for cls in ("fog", "rain", "snow", "sun"):  # 3 test images a class
        pngs = sorted(os.listdir(tmp_path / cls))
        assert len(pngs) == 3
        with Image.open(tmp_path / cls / pngs[0]) as im:
            assert im.size == (64, 48)


@pytest.mark.parametrize("target", ["dir", "file"])
def test_inference_json_equals_jax_cli(tiny_imagefolder, f1_checkpoint, tmp_path, target):
    src = tiny_imagefolder / "test"
    if target == "file":
        src = src / "rain" / "img_001.png"
    j_dir, t_dir = _both(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "inference",
                         "--inference_input", str(src), "--measure_time")
    out = []
    for d in (j_dir, t_dir):
        with open(d / "inference_predictions.json", encoding="utf-8") as f:
            out.append(json.load(f))
    j, t = out
    assert list(t) == list(j) == ["num_images", "classes", "predictions", "timing"]
    assert t["num_images"] == j["num_images"] == (N_TEST if target == "dir" else 1)
    assert t["classes"] == j["classes"]
    assert list(t["timing"]) == list(j["timing"])
    for a, b in zip(t["predictions"], j["predictions"]):
        assert list(a) == list(b)
        for k in ("image_path", "predicted_class_index", "predicted_class"):
            assert a[k] == b[k]
        np.testing.assert_allclose(a["predicted_probability"], b["predicted_probability"],
                                   atol=1e-5)
        assert list(a["class_probabilities"]) == list(b["class_probabilities"])
        np.testing.assert_allclose(list(a["class_probabilities"].values()),
                                   list(b["class_probabilities"].values()), atol=1e-5)


def test_camera_on_a_video_file_matches_jax_cli(tiny_imagefolder, f1_checkpoint, tmp_path):
    import cv2

    video = str(tmp_path / "in.avi")
    w = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (64, 48))
    rng = np.random.RandomState(0)
    for _ in range(4):
        w.write(rng.randint(0, 255, (48, 64, 3), dtype=np.uint8))
    w.release()
    j_dir, t_dir = _both(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "camera",
                         "--camera_index", video, "--measure_time", "--prob_threshold", "0.0")
    lens = []
    for d in (j_dir, t_dir):
        with open(d / "times_camera.json") as f:
            lens.append(len(json.load(f)))
    assert lens == [4, 4]


def test_parser_has_every_jax_flag():
    from heuristique_style_transfer_code_tpu.cli.test_truncated_resnet50 import (
        build_parser as j_parser,
    )
    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import (
        build_parser,
    )

    def flags(parser):
        return {a.option_strings[0]: (a.default, a.choices) for a in parser._actions
                if a.option_strings and a.dest != "help"}

    want, got = flags(j_parser()), flags(build_parser())
    assert set(got) - set(want) == {"--device"}
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("extra", [["--precision", "int8"], ["--devices", "2"]])
def test_unported_modes_and_flags_raise(tiny_imagefolder, f1_checkpoint, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(_args(tiny_imagefolder, f1_checkpoint, tmp_path, *extra, "--device", "cpu"))


def test_steps_per_dispatch_gives_the_k1_metrics(tiny_imagefolder, f1_checkpoint, tmp_path):
    """``--steps_per_dispatch 2`` over 3 batches (a chunk of 2, a tail of
    1): metrics.txt byte for byte the K = 1 run's (the JAX recipe's check),
    and the JAX CLI's K = 2 run as in the classification test."""
    runs = {}
    for k in ("1", "2"):
        out = tmp_path / f"k{k}"
        main(_args(tiny_imagefolder, f1_checkpoint, out, "--mode", "classification",
                   "--prob_threshold", "0.0", "--steps_per_dispatch", k, "--device", "cpu"))
        with open(out / "metrics.txt", "rb") as f:
            runs[k] = f.read()
    assert runs["2"] == runs["1"]
    j_main(_args(tiny_imagefolder, f1_checkpoint, tmp_path / "jax", "--mode", "classification",
                 "--prob_threshold", "0.0", "--steps_per_dispatch", "2"))
    (j_lines, j_cm), (t_lines, t_cm) = _metrics(tmp_path / "jax"), _metrics(tmp_path / "k2")
    assert t_cm == j_cm and t_lines["Score F1"] == j_lines["Score F1"]
    np.testing.assert_allclose(float(t_lines["Perte du test"]), float(j_lines["Perte du test"]),
                               rtol=1e-5)


def test_steps_per_dispatch_with_measure_time_keeps_the_jax_error(tiny_imagefolder,
                                                                 f1_checkpoint, tmp_path):
    flags = ("--mode", "classification", "--steps_per_dispatch", "2", "--measure_time")
    with pytest.raises(ValueError) as jax_err:
        j_main(_args(tiny_imagefolder, f1_checkpoint, tmp_path / "jax", *flags))
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        main(_args(tiny_imagefolder, f1_checkpoint, tmp_path / "torch", *flags, "--device",
                   "cpu"))


def test_profile_dir_writes_a_chrome_trace(tiny_imagefolder, f1_checkpoint, tmp_path, capsys):
    prof = tmp_path / "prof"
    main(_args(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "classification",
               "--profile_dir", str(prof), "--device", "cpu"))
    assert f"Profiler trace written to {prof}" in capsys.readouterr().out
    (trace,) = [n for n in os.listdir(prof) if n.endswith(".pt.trace.json")]
    with open(prof / trace) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::convolution" in names


def test_debug_nans_raises_at_a_nan_weight(tiny_imagefolder, f1_checkpoint, tmp_path):
    """A clean run with ``--debug_nans`` gives the plain run's metrics; one
    NaN in a conv kernel stops it with ``FloatingPointError``, as
    ``jax_debug_nans`` does."""
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
        load_pytree_npz,
        save_pytree_npz,
    )

    flags = ("--mode", "classification", "--prob_threshold", "0.0", "--device", "cpu")
    main(_args(tiny_imagefolder, f1_checkpoint, tmp_path / "plain", *flags))
    main(_args(tiny_imagefolder, f1_checkpoint, tmp_path / "debug", *flags, "--debug_nans"))
    assert _metrics(tmp_path / "debug") == _metrics(tmp_path / "plain")
    tree = load_pytree_npz(f1_checkpoint[1])
    tree["moco"]["encoder"]["conv1"]["kernel"][0, 0, 0, 0] = np.nan
    nan_ckpt = str(tmp_path / "nan.npz")
    save_pytree_npz(tree, nan_ckpt)
    with pytest.raises(FloatingPointError, match="invalid value"):
        main(_args(tiny_imagefolder, (f1_checkpoint[0], nan_ckpt), tmp_path / "nan", *flags,
                   "--debug_nans"))


def test_inference_guards_keep_the_jax_messages(tiny_imagefolder, f1_checkpoint, tmp_path):
    with pytest.raises(ValueError, match="--inference_input doit être spécifié"):
        main(_args(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "inference",
                   "--device", "cpu"))
    with pytest.raises(SystemExit, match="--steps_per_dispatch 1 avec --measure_time"):
        main(_args(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "inference",
                   "--inference_input", str(tiny_imagefolder), "--steps_per_dispatch", "2",
                   "--measure_time", "--device", "cpu"))


def test_checkpoint_without_the_family1_tree_raises(tiny_imagefolder, f1_checkpoint, tmp_path):
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
        load_pytree_npz,
        save_pytree_npz,
    )

    cfg, ckpt = f1_checkpoint
    tree = load_pytree_npz(ckpt)
    bad = str(tmp_path / "moco_only.npz")
    save_pytree_npz({"moco": tree["moco"]}, bad)
    with pytest.raises(KeyError, match="family-1"):
        main(["--config_path", cfg, "--model_path", bad, "--data", str(tiny_imagefolder),
              "--save_dir", str(tmp_path), "--device", "cpu"])


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(tiny_imagefolder, f1_checkpoint,
                                                              tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_args(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "classification"))
