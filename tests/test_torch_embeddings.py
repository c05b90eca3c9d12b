"""The port's embedding modes against the JAX package: ``tasks/embeddings``
for families 1, 2 and 3 on the same staged images and weights, the
family-1 CLI's ``tsne``, ``tsne_interactive`` and ``clustering`` artifacts
against the JAX CLI's on the same checkpoint, and the port's own copies of
``tasks/tsne.py`` and ``tasks/clustering.py`` against the originals.

Tolerances: embeddings 1e-4 relative to max|ref| (f32, another summation
order); everything that follows from the same embeddings (image paths,
labels, clusters, polygon JSON) equal. The clustering is fed the same
embeddings on both sides where the artifacts must be equal, since HDBSCAN
can split differently on inputs that differ in the last bits.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from heuristique_style_transfer_code_tpu.cli.test_truncated_resnet50 import main as j_main
from heuristique_style_transfer_code_tpu.data.loader import HostLoader as JHostLoader
from heuristique_style_transfer_code_tpu.tasks import clustering as jclustering
from heuristique_style_transfer_code_tpu.tasks import tsne as jtsne
from heuristique_style_transfer_code_tpu.tasks.embeddings import (
    compute_embeddings_with_paths as j_embeddings,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree
from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import main
from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader
from heuristique_style_transfer_code_tpu_torch.tasks import clustering, tsne
from heuristique_style_transfer_code_tpu_torch.tasks.embeddings import (
    compute_embeddings_with_paths,
)

BATCH = 4


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(autouse=True)
def _headless(monkeypatch):
    """No display: tsne_interactive takes its static fallback."""
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
def blob_imagefolder(tmp_path_factory):
    """A test split whose fog class holds two kinds of image (8 dark, 8
    bright), so HDBSCAN finds clusters in it; the other classes hold 2."""
    root = tmp_path_factory.mktemp("blobs")
    rng = np.random.RandomState(0)
    for ci, cls in enumerate(["fog", "rain", "snow", "sun"]):
        d = root / "test" / cls
        d.mkdir(parents=True)
        means = [30] * 8 + [220] * 8 if cls == "fog" else [60 + 40 * ci] * 2
        for i, mean in enumerate(means):
            img = np.clip(mean + rng.randn(48, 64, 3) * 10, 0, 255).astype(np.uint8)
            Image.fromarray(img).save(d / f"img_{i:03d}.png")
    return root


def _samples(data, n=None):
    samples = ImageFolderIndex(os.path.join(str(data), "test")).samples
    return samples[:n] if n else samples


def _family1(f1_checkpoint):
    from heuristique_style_transfer_code_tpu.checkpoint.io import load_pytree_npz
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
        truncated_moco_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.cli._common import load_truncated_resnet50
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_moco_apply,
    )

    _, ckpt = f1_checkpoint
    tree = load_pytree_npz(ckpt)
    model = load_truncated_resnet50(ckpt, 5, torch.device("cpu"))
    return (tree, lambda v, x: j_apply(v["moco"], x, 5)[0], model,
            lambda m, x: truncated_moco_apply(m.moco, x, 5))


def _family2():
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_init as j_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )

    tree = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(3), 5, 4, 4))
    model = load_jax_tree(gram_attention_init(None, 5, 4, 4, device="cpu"), tree)
    return (tree, lambda v, x: j_apply(v, x, 5, 4, 4)[0], model,
            lambda m, x: gram_attention_apply(m, x, 5, 4, 4)[0])


def _family3():
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import (
        multiscale_test_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import (
        multiscale_test_init as j_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_apply,
        multiscale_test_init,
    )

    sizes = {"small": 10, "medium": 70, "large": 150}
    tree = jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(4), sizes, ndf=8,
                                                     num_classes=4, gram_matrix_dim=8))
    model = load_jax_tree(multiscale_test_init(None, sizes, ndf=8, num_classes=4,
                                               gram_matrix_dim=8, device="cpu"), tree)
    return (tree, lambda v, x: j_apply(v, x, 8)[0], model,
            lambda m, x: multiscale_test_apply(m, x, 8)[0])


@pytest.mark.parametrize("family", ["family1", "family2", "family3"])
def test_embeddings_equal_jax(tiny_imagefolder, f1_checkpoint, family):
    """Ten samples in batches of 4 (the last one padded): the same paths
    and labels in the loader's order, and the embeddings to 1e-4."""
    tree, j_embed, model, embed = {"family1": lambda: _family1(f1_checkpoint),
                                   "family2": _family2, "family3": _family3}[family]()
    samples = _samples(tiny_imagefolder)[:10]
    j_emb, j_labels, j_paths = j_embeddings(j_embed, tree, JHostLoader(samples, BATCH,
                                                                       shuffle=False), samples)
    emb, labels, paths = compute_embeddings_with_paths(embed, model,
                                                       HostLoader(samples, BATCH), samples)
    assert paths == j_paths == [s[0] for s in samples]
    assert labels.tolist() == np.asarray(j_labels).tolist()
    assert emb.shape == np.asarray(j_emb).shape and emb.dtype == np.float32
    assert _rel(emb, j_emb) <= 1e-4


def test_embeddings_raise_for_a_mesh_or_several_steps(tiny_imagefolder, f1_checkpoint):
    """A data-parallel mesh is still refused; several steps a dispatch
    (``steps_per_dispatch`` 2 over 3 batches: a chunk of 2, a tail of 1)
    give the one-step embeddings, labels and paths bit for bit."""
    _, _, model, embed = _family1(f1_checkpoint)
    samples = _samples(tiny_imagefolder, 3 * BATCH - 1)
    with pytest.raises(NotImplementedError, match="not ported yet"):
        compute_embeddings_with_paths(embed, model, HostLoader(samples, BATCH), samples,
                                      mesh=object())
    one, two = (compute_embeddings_with_paths(embed, model, HostLoader(samples, BATCH), samples,
                                              steps_per_dispatch=k) for k in (1, 2))
    assert np.array_equal(two[0], one[0]) and np.array_equal(two[1], one[1])
    assert two[2] == one[2] and one[0].shape[0] == len(samples)


def _args(data, f1_checkpoint, save_dir, *extra):
    cfg, ckpt = f1_checkpoint
    return ["--data", str(data), "--config_path", cfg, "--model_path", ckpt,
            "--save_dir", str(save_dir), "--batch_size", str(BATCH), *extra]


def _both(data, f1_checkpoint, tmp_path, *flags):
    j_main(_args(data, f1_checkpoint, tmp_path / "jax", *flags))
    main(_args(data, f1_checkpoint, tmp_path / "torch", *flags, "--device", "cpu"))
    return tmp_path / "jax", tmp_path / "torch"


def _load(path):
    with open(path) as f:
        return json.load(f)


def _check_embeddings_json(j_dir, t_dir):
    """``model_embeddings.json`` (the checkpoint is model.npz): the same
    keys and labels, the embeddings to 1e-4."""
    j, t = _load(j_dir / "model_embeddings.json"), _load(t_dir / "model_embeddings.json")
    assert list(t) == list(j) == ["embeddings", "labels"]
    assert t["labels"] == j["labels"]
    assert _rel(t["embeddings"], j["embeddings"]) <= 1e-4
    return t


@pytest.mark.parametrize("mode", ["tsne", "tsne_interactive"])
def test_family1_tsne_modes_equal_jax_cli(tiny_imagefolder, f1_checkpoint, tmp_path, mode):
    """Both modes export the embeddings; without a display both write the
    static ``tsne_plot.png``."""
    j_dir, t_dir = _both(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", mode)
    t = _check_embeddings_json(j_dir, t_dir)
    assert len(t["embeddings"]) == 12 and len(t["embeddings"][0]) == 16
    assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir)) == [
        "model_embeddings.json", "tsne_plot.png"]
    with Image.open(t_dir / "tsne_plot.png") as im:
        assert im.size == (1000, 1000)


def test_family1_clustering_equals_jax_cli(blob_imagefolder, f1_checkpoint, tmp_path):
    flags = ["--mode", "clustering", "--clustering_class", "fog", "--min_cluster_size", "3", "4",
             "--min_samples", "2"]
    j_dir, t_dir = _both(blob_imagefolder, f1_checkpoint, tmp_path, *flags)
    _check_embeddings_json(j_dir, t_dir)
    got, want = (_load(d / "fog_clustering_results.json") for d in (t_dir, j_dir))
    assert list(got) == ["num_clusters", "clusters", "best_params"]
    assert got["num_clusters"] >= 2
    assert got == want
    assert os.path.exists(t_dir / "tsne_plot.png")  # the interactive view's fallback


def test_clustering_on_the_same_embeddings_equals_jax(blob_imagefolder, f1_checkpoint,
                                                      tmp_path):
    """``run_clustering`` of both packages fed the JAX CLI's embeddings."""
    j_dir = tmp_path / "jax"
    j_main(_args(blob_imagefolder, f1_checkpoint, j_dir, "--mode", "tsne"))
    data = _load(j_dir / "model_embeddings.json")
    emb, labels = np.asarray(data["embeddings"], np.float32), np.asarray(data["labels"])
    paths = [s[0] for s in _samples(blob_imagefolder)]
    classes = ["fog", "rain", "snow", "sun"]
    out = []
    for fn, side in ((jclustering.run_clustering, "j"), (clustering.run_clustering, "t")):
        res = fn(emb, labels, paths, classes, "fog", (3, 5), (1, 2), str(tmp_path / side),
                 interactive=False)
        out.append((res, _load(tmp_path / side / "fog_clustering_results.json")))
    (j_res, j_file), (t_res, t_file) = out
    assert t_res == j_res and t_file == j_file


def test_clustering_without_a_class_keeps_the_jax_message(tiny_imagefolder, f1_checkpoint,
                                                          tmp_path):
    with pytest.raises(ValueError, match="--clustering_class doit être spécifiée"):
        main(_args(tiny_imagefolder, f1_checkpoint, tmp_path, "--mode", "clustering",
                   "--device", "cpu"))
    assert os.path.exists(tmp_path / "model_embeddings.json")  # exported before the guard


@pytest.mark.parametrize("name,want", [("model.npz", "model"), ("best.pth", "best"),
                                       ("run.orbax", "run"), ("weights", "weights")])
def test_embeddings_json_name_follows_the_jax_rule(tmp_path, name, want):
    from heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 import (
        write_embeddings_json,
    )

    path = write_embeddings_json(np.ones((2, 3), np.float32), np.array([0, 1]),
                                 str(tmp_path / "ckpt" / name), str(tmp_path / "out"))
    assert os.path.basename(path) == f"{want}_embeddings.json"
    assert _load(path) == {"embeddings": [[1.0] * 3] * 2, "labels": [0, 1]}


def test_perform_tsne_and_polygon_analysis_equal_jax(tmp_path):
    rng = np.random.RandomState(5)
    emb = rng.randn(20, 6).astype(np.float32)
    labels = np.repeat(np.arange(4), 5)
    classes = ["fog", "rain", "snow", "sun"]
    for module, side in ((jtsne, "j"), (tsne, "t")):
        path = module.perform_tsne(emb, labels, classes, None, str(tmp_path / side),
                                   filename="tsne_visualization.png")
        assert os.path.basename(path) == "tsne_visualization.png" and os.path.getsize(path) > 0
    np.testing.assert_array_equal(tsne._tsne_2d(emb), jtsne._tsne_2d(emb))
    pts = tsne._tsne_2d(emb)
    polygon = [(-100.0, -100.0), (0.0, -100.0), (0.0, 100.0), (-100.0, 100.0)]
    paths = [f"img_{i}.png" for i in range(20)]
    got = tsne.analyze_polygon_points(pts, polygon, labels, classes, paths, str(tmp_path / "t"))
    want = jtsne.analyze_polygon_points(pts, polygon, labels, classes, paths,
                                        str(tmp_path / "j"))
    assert got == want
    for name in ("inside_polygon.json", "outside_polygon.json"):
        assert _load(tmp_path / "t" / name) == _load(tmp_path / "j" / name)


def test_interactive_controller_on_an_agg_canvas(tmp_path):
    """The Tk-free controller of the port's copy: pick, zoom, polygon,
    analyse, clear (the JAX package's own controller test, on the port)."""
    import matplotlib

    matplotlib.use("Agg")
    from types import SimpleNamespace

    pts = np.array([[0.0, 0.0], [0.5, 0.5], [3.0, 3.0], [-3.0, 2.0], [0.2, -0.3]])
    labels = np.array([0, 1, 2, 3, 0])
    paths = []
    for i in range(5):
        p = tmp_path / f"img_{i}.png"
        Image.fromarray(np.full((8, 8, 3), 40 * i, np.uint8)).save(p)
        paths.append(str(p))

    class View:
        def set_image(self, img):
            self.image = img

        def set_label(self, text):
            self.label = text

        def set_inside_count(self, text):
            self.inside = text

        def set_dropdown(self, values, current):
            self.dropdown = (values, current)

    view = View()
    ctl = tsne.TsneInteractiveController(pts, labels, ["fog", "rain", "snow", "sun"], paths,
                                         view, str(tmp_path))
    ctl.onpick(SimpleNamespace(ind=[2]))
    assert view.image.size == (400, 400) and view.label == "Label: snow"
    x0, x1 = ctl.ax.get_xlim()
    ctl.on_key(SimpleNamespace(key="z", xdata=0.0, ydata=0.0))
    assert ctl.ax.get_xlim()[1] - ctl.ax.get_xlim()[0] < x1 - x0
    ctl.enable_polygon_selector(SimpleNamespace(button=3))
    assert ctl._selector is not None
    ctl.onselect([(-1.0, -1.0), (1.0, -1.0), (1.0, 1.0), (-1.0, 1.0)])
    inside = ctl.analyze()
    assert {p["path"] for p in inside} == {paths[0], paths[1], paths[4]}
    assert view.inside == "Points inside polygon: 3" and view.dropdown[1] == 0
    ctl.clear()
    assert ctl.polygon == [] and ctl._selector is None and view.inside == ""


def test_tsne_interactive_falls_back_to_the_static_plot(tmp_path):
    emb = np.random.RandomState(6).randn(12, 4).astype(np.float32)
    labels = np.repeat(np.arange(4), 3)
    path = tsne.plot_tsne_interactive(emb, labels, ["a", "b", "c", "d"],
                                      [f"{i}.png" for i in range(12)], save_dir=str(tmp_path))
    assert path == str(tmp_path / "tsne_plot.png") and os.path.getsize(path) > 0
