"""The port's Grad-CAM (``tasks/gradcam.py``), TensorBoard writer
(``cli/_common.make_writer``) and their wiring into family 1's
``--mode classification`` against the JAX package, on the CPU.

Weights: the port's seeded family-1 model through ``to_jax_tree`` (the
JAX side reads the same tree), or the ``f1_checkpoint`` fixture (truncate
5, dim 16, JAX init) for the CLIs. Inputs: staged 256² uint8 from numpy
seeds.

Tolerances: the float64 CAMs 1e-9; the f32 CAMs 1e-4 max abs of the
float64 one, and of JAX's plus JAX's own f32 error (see the test; each
compared CAM is first shown not to be degenerate: before the resize it
spans [0, 1] with pixels strictly inside, so its range was above the 1e-7
floor of the min-max); the overlay arrays
(the same OpenCV and Pillow calls on the same CAM) exact; the CLIs'
overlay PNGs panel by panel (see the CLI test: a CAM one step apart picks
the colormap's neighbouring colour);
the writer's records equal (the same annotated image and text)."""
import copy
import os
import re
import sys

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.cli import test_truncated_resnet50 as j_cli
from heuristique_style_transfer_code_tpu.tasks import gradcam as j_gc
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
from heuristique_style_transfer_code_tpu_torch.cli import test_truncated_resnet50 as p_cli
from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
    truncated_resnet50_init,
)
from heuristique_style_transfer_code_tpu_torch.tasks import gradcam as p_gc


def _model(truncate):
    model = truncated_resnet50_init(torch.Generator().manual_seed(truncate), truncate, 4, 16,
                                    device="cpu")
    return model, to_jax_tree(model)


def _staged(n, seed=1):
    return np.random.RandomState(seed).randint(0, 256, (n, 256, 256, 3)).astype(np.uint8)


@pytest.mark.parametrize("truncate", [5, 6, 8])
def test_gradcam_moco_matches_jax(truncate):
    """Two images, each with every class as the target.

    In float64 the two CAMs (before the resize) are the same function: all
    eight agree to 1e-9. In f32, on seeded weights, the weighted sum
    ReLU(sum w A) cancels heavily over the channels, and JAX's own f32 CAM
    then lies up to 3e-4 from its float64 value at truncate 6 (the port's
    within 1e-5); so the port's f32 CAM is held within 1e-4 of the float64
    one, and within 1e-4 plus JAX's own f32 error of JAX's. A CAM that is
    all but zero (the min-max then divides by its 1e-7 floor, which no
    tolerance survives) is left out of the f32 checks, and at least half of
    them must be real."""
    import jax

    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess
    from heuristique_style_transfer_code_tpu_torch.ops.resize import resize_image

    model, tree = _model(truncate)
    images = np.repeat(_staged(2), 4, axis=0)
    targets = [0, 1, 2, 3] * 2
    x64 = eval_preprocess(torch.from_numpy(images)).double()
    raw64 = p_gc._cam_for_moco(copy.deepcopy(model).double(), x64, torch.tensor(targets),
                               truncate)
    with jax.enable_x64():
        tree64 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)
        want64 = np.asarray(j_gc._cam_for_moco(tree64, jax.numpy.asarray(x64.numpy()),
                                               jax.numpy.asarray(targets), truncate))
    assert want64.dtype == np.float64 and np.abs(raw64.numpy() - want64).max() <= 1e-9

    # a real CAM spans [0, 1] with pixels strictly inside: its range was above the floor
    real = [k for k, cam in enumerate(raw64.numpy())
            if cam.max() == pytest.approx(1.0) and ((cam > 0.01) & (cam < 0.99)).mean() > 0.02]
    assert len(real) >= 4, [float(c.max()) for c in raw64]
    truth = torch.clamp(resize_image(raw64[..., None].float(), 224, 224)[..., 0], 0, 1).numpy()
    want = np.asarray(j_gc.gradcam_moco(tree, images, targets, truncate=truncate))
    got = p_gc.gradcam_moco(model, images, targets, truncate=truncate).numpy()
    assert got.shape == want.shape == (8, 224, 224)
    assert np.abs(got[real] - truth[real]).max() <= 1e-4
    jax_own = np.abs(want[real] - truth[real]).max()
    assert np.abs(got[real] - want[real]).max() <= 1e-4 + jax_own


def test_gradcam_truncate_below_5_raises_the_jax_message():
    model, tree = _model(4)
    with pytest.raises(ValueError) as jax_err:
        j_gc.gradcam_moco(tree, _staged(1), [0], truncate=4)
    with pytest.raises(ValueError, match=re.escape(str(jax_err.value))):
        p_gc.gradcam_moco(model, _staged(1), [0], truncate=4)


def test_gradcam_inside_and_after_inference_mode():
    """The classification loop runs under ``torch.inference_mode``: a CAM
    taken after it, with the resize matrices first cached there, and one
    taken inside it both record their gradient and give the same CAM."""
    from heuristique_style_transfer_code_tpu_torch.ops import resize
    from heuristique_style_transfer_code_tpu_torch.tasks.classification import (
        evaluate_classification,
    )

    model, _ = _model(5)
    images = _staged(2, seed=3)
    resize._resize_matrix_on.cache_clear()
    resize._imagenet_on.cache_clear()
    with torch.inference_mode():  # the CAM's 56 -> 224 resize matrix, cached here first
        resize.resize_image(torch.zeros((1, 56, 56, 1)), 224, 224)
    batch = {"image": images, "label": np.array([0, 1], np.int32), "indices": np.arange(2),
             "n_valid": 2}
    fwd = lambda m, x: p_cli.combined_apply(m.moco, m.classifier, x, 5)  # noqa: E731
    res = evaluate_classification(fwd, model, [batch], 4, prob_threshold=0.0)
    after = p_gc.gradcam_moco(model, images, res["targets"], truncate=5)
    with torch.inference_mode():
        inside = p_gc.gradcam_moco(model, images, res["targets"], truncate=5)
    assert after.max() > 0.5
    torch.testing.assert_close(inside, after, rtol=0, atol=0)


def _cam_and_image(tmp_path):
    from PIL import Image

    path = str(tmp_path / "orig.png")
    rgb = np.random.RandomState(4).randint(0, 256, (48, 64, 3)).astype(np.uint8)
    Image.fromarray(rgb).save(path)
    yy, xx = np.mgrid[0:224, 0:224] / 223.0
    return ((np.sin(5 * xx) * np.cos(3 * yy) + 1) / 2).astype(np.float32), path


@pytest.mark.parametrize("colormap", ["jet", "viridis", "no_such_map"])
def test_heatmap_overlays_match_jax(tmp_path, colormap):
    import cv2

    cam, path = _cam_and_image(tmp_path)
    want = j_gc.generate_heatmap_overlays(cam, path, str(tmp_path / "jax" / "o.png"), colormap)
    got = p_gc.generate_heatmap_overlays(cam, path, str(tmp_path / "port" / "o.png"), colormap)
    assert got.shape == (224, 672, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "port" / "o.png")),
                                  cv2.imread(str(tmp_path / "jax" / "o.png")))
    if colormap == "no_such_map":  # an unknown name falls back to "hot"
        hot = p_gc.generate_heatmap_overlays(cam, path, None, "hot")
        np.testing.assert_array_equal(got, hot)
    assert p_gc.generate_heatmap_overlays(cam, path, None, colormap).shape == got.shape


def test_custom_colormap_matches_jax():
    want = j_gc.create_custom_colormap()
    got = p_gc.create_custom_colormap()
    assert got.name == want.name == "custom_cmap" and got.N == want.N == 256
    x = np.linspace(0.0, 1.0, 256)
    np.testing.assert_array_equal(got(x), want(x))


def _cli_args(data, f1_checkpoint, save_dir, *extra):
    cfg, ckpt = f1_checkpoint
    return ["--data", str(data), "--config_path", cfg, "--model_path", ckpt,
            "--save_dir", str(save_dir), "--batch_size", "2", "--num_samples", "4",
            "--mode", "classification", "--save_test_images", *extra]


def _tree(root):
    out = set()
    for d, _, files in os.walk(root):
        rel = os.path.relpath(d, root)
        out.update(os.path.join(rel, f) for f in files
                   if not f.startswith("events.out.tfevents"))
    return out


def test_classification_cli_gradcam_tree_matches_jax(tiny_imagefolder, f1_checkpoint, tmp_path):
    """The same file tree as the JAX CLI's. Each overlay is the port's own
    CAM of that image through ``generate_heatmap_overlays``, byte for byte;
    against JAX's file: the original panel equal, the grayscale CAM panel
    within one step, the coloured panel within the colormap's steepest step
    between neighbouring entries (5 for jet) plus one: a CAM one index
    apart picks the neighbouring colour."""
    import cv2

    from heuristique_style_transfer_code_tpu_torch.cli._common import (
        load_truncated_resnet50,
        maybe_subset,
    )
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import load_image_staged

    flags = ("--visualize_gradcam", "--save_gradcam_images", "--tensorboard",
             "--colormap", "jet")
    j_cli.main(_cli_args(tiny_imagefolder, f1_checkpoint, tmp_path / "jax", *flags))
    p_cli.main(_cli_args(tiny_imagefolder, f1_checkpoint, tmp_path / "port", *flags,
                         "--device", "cpu"))
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got == want
    overlays = sorted(f for f in got if f.split(os.sep)[0].startswith("GradCAM_"))
    assert len(overlays) == 4
    samples = maybe_subset(ImageFolderIndex(str(tiny_imagefolder / "test")).samples, 4, 0)
    model = load_truncated_resnet50(f1_checkpoint[1], 5, torch.device("cpu"))
    ramp = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None], cv2.COLORMAP_JET)
    steepest = int(np.abs(np.diff(ramp.astype(np.int16), axis=0)).max())
    for f in overlays:
        bi, j = map(int, os.path.basename(f)[len("gradcam_"):-len(".png")].split("_"))
        path, label = samples[2 * bi + j]
        cam = p_gc.gradcam_moco(model, load_image_staged(path)[None], [label], truncate=5)[0]
        mine = p_gc.generate_heatmap_overlays(cam.numpy(), path, None, "jet")
        a = cv2.imread(str(tmp_path / "port" / f))
        np.testing.assert_array_equal(
            a, cv2.cvtColor((mine * 255).astype(np.uint8), cv2.COLOR_RGB2BGR))
        a, b = a.astype(np.int16), cv2.imread(str(tmp_path / "jax" / f)).astype(np.int16)
        assert a.shape == b.shape == (224, 672, 3)
        gap = np.abs(a - b)
        assert gap[:, :224].max() == 0 and gap[:, 448:].max() <= 1, f
        assert gap[:, 224:448].max() <= steepest + 1, f
    for side in ("jax", "port"):  # one event file each
        events = os.listdir(tmp_path / side / "TensorBoard")
        assert len(events) == 1 and events[0].startswith("events.out.tfevents")


def test_visualize_without_save_writes_no_overlay(tiny_imagefolder, f1_checkpoint, tmp_path):
    p_cli.main(_cli_args(tiny_imagefolder, f1_checkpoint, tmp_path, "--visualize_gradcam",
                         "--device", "cpu"))
    assert not any(d.startswith("GradCAM_") for d in os.listdir(tmp_path))
    assert sum(len(os.listdir(tmp_path / c)) for c in ("fog", "rain", "snow", "sun")) == 4


class _RecordingWriter:
    def __init__(self):
        self.calls = []

    def add_image(self, tag, img, global_step=None):
        self.calls.append(("image", tag, np.asarray(img).copy(), global_step))

    def add_text(self, tag, text, global_step=None):
        self.calls.append(("text", tag, text, global_step))

    def close(self):
        self.calls.append(("close",))


def test_writer_receives_the_jax_records(tiny_imagefolder, f1_checkpoint, tmp_path,
                                         monkeypatch):
    writers = {}
    for side, cli in (("jax", j_cli), ("port", p_cli)):
        monkeypatch.setattr(cli, "make_writer", lambda enabled, save_dir, sub, side=side: (
            writers.setdefault(side, _RecordingWriter()) if enabled else None))
        extra = ["--device", "cpu"] if side == "port" else []
        cli.main(_cli_args(tiny_imagefolder, f1_checkpoint, tmp_path / side, "--tensorboard",
                           "--prob_threshold", "0.0", *extra))
    want, got = writers["jax"].calls, writers["port"].calls
    assert len(got) == len(want) == 2 * 4 + 1 and got[-1] == ("close",)
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[1:2] == w[1:2] and g[3:] == w[3:]
        if g[0] == "image":
            assert g[2].shape[0] == 3
            np.testing.assert_array_equal(g[2], w[2])
        elif g[0] == "text":
            assert g[2] == w[2]
    assert [c[1] for c in got[:4]] == ["Test/Images/0_0", "Test/Prédictions/0_0",
                                       "Test/Images/0_1", "Test/Prédictions/0_1"]


def test_make_writer_without_tensorboard_keeps_the_jax_message(tmp_path, monkeypatch, capsys):
    from heuristique_style_transfer_code_tpu.cli._common import make_writer as j_make_writer
    from heuristique_style_transfer_code_tpu_torch.cli._common import make_writer

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # import fails
    assert j_make_writer(True, str(tmp_path), "TensorBoard") is None
    want = capsys.readouterr().out
    assert make_writer(True, str(tmp_path), "TensorBoard") is None
    assert capsys.readouterr().out == want == "TensorBoard unavailable; continuing without it.\n"
    assert make_writer(False, str(tmp_path)) is None
