"""Data-parallel evaluation of the port (``--devices N`` on the three
evaluation CLIs and ``mesh=`` on the style loops) on the CPU: two gloo
ranks spawned once for the module (``tests/torch_eval_ranks.py`` holds
their bodies, which import no jax), against the port's one-device run of
the same cases and against JAX's 2-device runs.

- The CLIs (each rank joins the ranks' group, as under ``torchrun``):
  family 1 ``classification`` over 10 samples at batch 4 (a ragged last
  batch of 2, one row a rank), ``inference`` at batch 8 over 12 images,
  ``tsne`` under ``--steps_per_dispatch 2``, int8 ``classification``
  fine-tuned first (``--qat_steps 1``: rank 0 fine-tunes, calibrates and
  writes ``--quantized_path``, which holds one device's tree, and the
  other rank takes the tree and the fine-tuned weights from a broadcast);
  family 2 ``classification`` and ``style_transfer``; family 3
  ``classification``. Rank 0
  writes the ``--devices 1`` run's files, each once: the text artifacts
  byte for byte, the JSON numbers within 1e-6 and the PNGs within one
  uint8 level (f32 rows computed in batches of another size).
- The three style loops in float64 at 32 px (family 2's texture loop,
  family 2's content+style loop, family 3's texture loop under instance
  norm), whose rank-0 rows stop at the first iteration while rank 1's run
  to the cap: the iteration count, the final per-image losses (f32, as
  the loops compute them) and the pixels of one device within 1e-10
  (every loss is a per-image sum; they come out equal). A rank that
  stopped on its own rows' ``any(active)`` would report one iteration and
  its rows' losses before their last update.
- JAX: ``make_style_transfer_optimizer(..., mesh=make_mesh_2d(2,
  model_parallel=1))`` on the same noise and targets gives the port's
  iteration count and losses within 2e-6 (float64 weights and pixels,
  but each package casts the Grams to f32 for the loss, as JAX's loop
  does, so the two packages' losses agree to f32's precision: 4.6e-7
  measured);
  the JAX family-1 CLI under ``--devices 2`` (``run_classification_test``
  on ``create_mesh(2)``) writes the port's metrics.txt (the counts and
  the confusion matrix equal, the loss and the AUC within 1e-5, as
  ``tests/test_torch_family1_cli.py`` holds the one-device CLIs).
"""
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.parallel import multihost
from tests import torch_eval_ranks as R

RANK_CASES = tuple(R.CASES)
LOOPS = ("f2_texture", "f3_texture", "content_style")
F64_TOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _write_models(in_dir: str) -> dict:
    """The CLIs' checkpoints and configs (the port's seeded weights, in the
    JAX layout both packages read) and the loops' weight trees."""
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
        multiscale_test_init,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_resnet50_init,
    )

    save_pytree_npz(to_jax_tree(truncated_resnet50_init(torch.Generator().manual_seed(2), 5, 4,
                                                        16, device="cpu")),
                    os.path.join(in_dir, "f1.npz"))
    with open(os.path.join(in_dir, "f1.json"), "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "seed": 0, "dim": 16}, f)
    f2 = to_jax_tree(gram_attention_init(torch.Generator().manual_seed(0), R.F2_TRUNCATE, 4,
                                         R.F2_S, device="cpu"))
    f3 = to_jax_tree(multiscale_test_init(torch.Generator().manual_seed(1), R.F3_PATCHES, ndf=8,
                                          num_classes=4, gram_matrix_dim=R.F3_GDIM,
                                          norm="instance", device="cpu"))
    save_pytree_npz(f2, os.path.join(in_dir, "f2.npz"))
    save_pytree_npz(f3, os.path.join(in_dir, "f3.npz"))
    with open(os.path.join(in_dir, "f2.json"), "w") as f:
        json.dump({"batch_size": 4, "lr": 0.01, "truncate_layer": R.F2_TRUNCATE,
                   "gram_matrix_size": R.F2_S, "num_classes": 4, "seed": 0}, f)
    with open(os.path.join(in_dir, "f3.json"), "w") as f:
        json.dump({"batch_size": 4, "seed": 0, "ndf": 8, "gram_matrix_dim": R.F3_GDIM,
                   "num_classes": 4, "norm": "instance", "patch_sizes": R.F3_PATCHES}, f)
    return {"f2_tree": f2, "f3_tree": f3}


def _between(first) -> float:
    """A threshold between rows 0-1's first losses and rows 2-3's."""
    first = np.asarray(first)
    low, high = first[: R.B // 2].max(), first[R.B // 2:].min()
    assert low < high / 100, first
    return float(np.sqrt(low * high))


def _inputs(in_dir: str, data: str) -> dict:
    from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

    rng = np.random.RandomState(0)
    inputs = _write_models(in_dir)
    inputs["noise"] = rng.randn(R.B, R.PX, R.PX, 3)
    inputs["content"] = rng.randn(R.B, R.PX, R.PX, 3)
    style = rng.randn(1, R.PX, R.PX, 3)
    inputs["cs_style"] = style
    inputs["cs_content"] = np.concatenate([style + R.NEAR * rng.randn(2, R.PX, R.PX, 3),
                                           rng.randn(2, R.PX, R.PX, 3)])
    inputs["f2_targets"] = R.texture_targets(
        pst.make_gram_fn_gram_attention(R.f2_model(inputs), R.F2_TRUNCATE), inputs).numpy()
    inputs["f3_targets"] = R.texture_targets(
        pst.make_gram_fn_patches(R.f3_model(inputs), R.F3_GDIM, norm="instance"),
        inputs).numpy()
    firsts = {"f2": R.run_texture(None, inputs, "f2", iters=1, threshold=0.0)["per"],
              "f3": R.run_texture(None, inputs, "f3", iters=1, threshold=0.0)["per"],
              "content_style": R.run_content_style(None, inputs, iters=1, threshold=0.0)["per"]}
    for key, first in firsts.items():
        inputs[f"{key}_threshold"] = np.float64(_between(first))
        inputs[f"{key}_first"] = first
    save_pytree_npz(inputs, os.path.join(in_dir, "inputs.npz"))
    with open(os.path.join(in_dir, "paths.json"), "w") as f:
        json.dump({"_data": data, "_in": in_dir}, f)
    return R.load_inputs(in_dir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_imagefolder):
    """(inputs, the one-device results, rank 0's and rank 1's results, the
    one-device and the two-rank output directories, the spawn's
    seconds)."""
    root = tmp_path_factory.mktemp("eval_dp")
    in_dir, one_dir, two_dir = (str(root / d) for d in ("in", "one", "two"))
    for d in (in_dir, one_dir, two_dir):
        os.makedirs(d)
    inputs = _inputs(in_dir, str(tiny_imagefolder))
    spawn = {}

    def ranks_job():
        t0 = time.perf_counter()
        try:
            multihost.launch(2, None, [], target=R.rank_main,
                             target_args=(in_dir, two_dir, RANK_CASES),
                             rendezvous_dir=str(root), deadline_s=150.0)
        except SystemExit as e:
            spawn["error"] = e
        spawn["seconds"] = time.perf_counter() - t0

    job = threading.Thread(target=ranks_job)
    job.start()  # the ranks run while this process takes the one-device runs
    try:
        one = R.run_cases(None, in_dir, one_dir, RANK_CASES)
    finally:
        job.join()
    assert "error" not in spawn, spawn
    ranks = [load_pytree_npz(os.path.join(two_dir, f"rank{r}.npz")) for r in range(2)]
    return inputs, one, ranks, one_dir, two_dir, spawn["seconds"]


@pytest.mark.parametrize("case", LOOPS)
def test_style_loop_two_ranks_match_one_device(runs, case):
    """The loop ran to the cap (rank 1's rows) although rank 0's rows
    stopped at the first iteration; both ranks hold the one-device
    iteration count, final losses and pixels (1e-10); rank 0's
    rows report the loss at their frozen pixels, not their first loss."""
    inputs, one, ranks, _, _, _ = runs
    key = case.replace("_texture", "")
    first, threshold = inputs[f"{key}_first"], float(inputs[f"{key}_threshold"])
    assert (first[: R.B // 2] < threshold).all() and (first[R.B // 2:] > threshold).all()
    want = one[case]
    assert int(want["iters"]) == R.ITERS
    for rank in ranks:
        got = rank[case]
        assert int(got["iters"]) == R.ITERS
        np.testing.assert_allclose(got["per"], want["per"], rtol=F64_TOL, atol=0)
        np.testing.assert_allclose(got["pixels"], want["pixels"], rtol=0, atol=F64_TOL)
    stopped = want["per"][: R.B // 2]
    assert not np.allclose(stopped, first[: R.B // 2], rtol=1e-6, atol=0)


def _tree_files(root: str) -> dict:
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            out[os.path.relpath(path, root)] = path
    return out


def _numbers_close(a, b, what):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _numbers_close(a[k], b[k], f"{what}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _numbers_close(x, y, what)
    elif isinstance(a, float):
        assert abs(a - b) <= 1e-6, (what, a, b)
    else:
        assert a == b, what


CLI_CASES = tuple(R.CLI_CASES)


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_two_ranks_write_the_one_device_files(runs, case):
    """Rank 0 wrote every file of ``--devices 1``, each once (one tree, the
    same names): text byte for byte (metrics.txt, auc_score.txt,
    classification_results.json), the JSON of embeddings and inference
    probabilities within 1e-6, PNGs within one uint8 level."""
    from PIL import Image

    _, _, _, one_dir, two_dir, _ = runs
    one, two = _tree_files(os.path.join(one_dir, case)), _tree_files(os.path.join(two_dir, case))
    assert sorted(two) == sorted(one) and one, (sorted(one), sorted(two))
    for name, path in one.items():
        other = two[name]
        if name.endswith(".png"):
            with Image.open(path) as a, Image.open(other) as b:
                gap = np.abs(np.asarray(a, np.int16) - np.asarray(b, np.int16))
            assert gap.max() <= (0 if "confusion" in name or "tsne" in name else 1), name
        elif name.endswith(".json") and "classification_results" not in name:
            with open(path) as fa, open(other) as fb:
                a = json.loads(fa.read().replace(one_dir, "D"))
                b = json.loads(fb.read().replace(two_dir, "D"))
            _numbers_close(a, b, name)
        else:
            with open(path, "rb") as fa, open(other, "rb") as fb:
                assert fa.read() == fb.read(), name
    if "OUT_q.npz" in R.CLI_CASES[case]:  # rank 0 wrote --quantized_path: one device's tree
        want = load_pytree_npz(os.path.join(one_dir, case) + "_q.npz")
        got = load_pytree_npz(os.path.join(two_dir, case) + "_q.npz")
        flat = lambda t: dict(R.flat_leaves(t))  # noqa: E731
        assert flat(got).keys() == flat(want).keys()
        for k, v in flat(want).items():
            np.testing.assert_array_equal(flat(got)[k], v, err_msg=k)


def test_texture_loop_matches_jax_two_device_loop(runs):
    """JAX's texture optimiser on a 2-device data mesh, float64, on the
    same noise, targets and threshold: the port's two ranks' iteration
    count and per-image losses (2e-6: f32 losses, module docstring)."""
    import jax
    import jax.numpy as jnp

    from heuristique_style_transfer_code_tpu.parallel.sharding import make_mesh_2d
    from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
        make_gram_fn_gram_attention,
        make_style_transfer_optimizer,
    )

    inputs, _, ranks, _, _, _ = runs
    with jax.enable_x64():
        tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), inputs["f2_tree"])
        gram_fn = make_gram_fn_gram_attention(tree, R.F2_TRUNCATE)
        run = make_style_transfer_optimizer(gram_fn, R.LR, R.ITERS,
                                            float(inputs["f2_threshold"]),
                                            mesh=make_mesh_2d(2, model_parallel=1))
        _, iters, per = run(jnp.asarray(inputs["noise"]), [jnp.asarray(inputs["f2_targets"])])
        iters, per = int(iters), np.asarray(per)
    got = ranks[0]["f2_texture"]
    assert int(got["iters"]) == iters == R.ITERS
    np.testing.assert_allclose(got["per"], per, rtol=2e-6, atol=0)


def _metrics(path):
    with open(path, encoding="utf-8") as f:
        head, cm = f.read().split("Matrice de confusion:\n")
    return dict(line.split(": ", 1) for line in head.splitlines()), cm


def test_classification_metrics_match_jax_two_device_cli(runs, tmp_path):
    """The JAX family-1 CLI under ``--devices 2`` (``run_classification_test``
    on ``create_mesh(2)``) with the same flags: the port's two ranks'
    metrics.txt, the counts and the confusion matrix equal, the loss and
    the AUC within 1e-5."""
    from heuristique_style_transfer_code_tpu.cli.test_truncated_resnet50 import main as j_main

    inputs, _, _, _, two_dir, _ = runs
    spec = R.CLI_CASES["f1_classification"][1:]
    j_main(["--data", inputs["_data"], "--config_path", os.path.join(inputs["_in"], "f1.json"),
            "--model_path", os.path.join(inputs["_in"], "f1.npz"), "--save_dir", str(tmp_path),
            "--devices", "2", *spec])
    (j_lines, j_cm) = _metrics(tmp_path / "metrics.txt")
    (t_lines, t_cm) = _metrics(os.path.join(two_dir, "f1_classification", "metrics.txt"))
    assert list(t_lines) == list(j_lines)
    for key in ("Précision du test", "Précision", "Rappel", "Score F1"):
        assert t_lines[key] == j_lines[key], key
    assert t_cm == j_cm
    for key in ("Perte du test", "Score AUC"):
        np.testing.assert_allclose(float(t_lines[key]), float(j_lines[key]), rtol=1e-5)


def test_spawn_budget(runs):
    """The module's one spawn of two ranks, every case run on each, within
    120 s: about 18 s alone, 77 s inside the 6-worker tier-1 run (its
    processes share the host's cores with the other workers)."""
    assert runs[-1] < 120.0
