"""``--parallel_folds`` over a (fold, data) mesh of ranks
(``core.mesh.FoldMesh``, ``parallel/foldparallel.py``) on the CPU: four
gloo ranks spawned once for the module (``tests/torch_fold_ranks.py``
holds their bodies, which import no jax), against the port's one-device
fold-parallel runs and against JAX's fold mesh (the test session's
virtual CPU devices).

- The mesh's shape, the world of ranks and the partial-sharding warning
  against JAX's ``make_fold_mesh``, ``build_mesh`` and
  ``warn_partial_fold_sharding`` on a table of (K, n, B).
- One step on (fold 2, data 2) of family 2, fold 0 active and fold 1
  inactive: in f32 against JAX's ``make_foldwise_train_step`` on
  ``make_fold_mesh(2, 4, batch_size=8)``, in float64 against the port's
  one-device step; the states the ranks share after it.
- Three folds of family 3 (batch norms) under mixup on (fold 1, data 4):
  two float64 steps against one device, and the collectives the step
  makes.
- ``run_kfold`` on a 2 x 2 fold mesh (evaluation on the first 2 ranks)
  against the one-device ``--parallel_folds`` run, in float64.
- The family-3 train CLI at ``--devices 4``, its ranks joining the
  module's group as under ``torchrun``, against ``--devices 1``.
"""
import contextlib
import io
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    _flatten,
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.cli import _common as port_cli
from heuristique_style_transfer_code_tpu_torch.core.mesh import fold_mesh_shape, fold_world
from heuristique_style_transfer_code_tpu_torch.parallel import multihost
from tests import torch_fold_ranks as R

F64_TOL, F32_TOL = 1e-10, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# (K, n, B): 8 devices at B 6 with K 4 (the fold mesh covers
# 8 devices, the evaluation mesh 6) and others where the two differ
MESH_TABLE = [(4, 8, 6), (2, 4, 8), (3, 4, 8), (2, 2, 4), (3, 8, 8), (5, 5, 4), (2, 7, 4),
              (4, 6, 8), (3, 6, 6), (2, 8, 2), (4, 3, 4), (6, 8, 12), (2, 1, 4)]


@pytest.mark.parametrize("k,n,b", MESH_TABLE)
def test_fold_mesh_shape_and_world_match_jax(k, n, b, capsys):
    """The port's (fold, data) and evaluation sizes are JAX's
    ``make_fold_mesh(K, n, batch_size=B)`` and ``build_mesh(n, B)``, both
    over the first devices, so the world is the larger; the warning is
    printed exactly where JAX's is (F < K)."""
    from heuristique_style_transfer_code_tpu.cli import _common as jax_cli
    from heuristique_style_transfer_code_tpu.parallel.foldparallel import make_fold_mesh

    mesh = make_fold_mesh(k, n, batch_size=b)
    want = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_eval = jax_cli.build_mesh(n, b).devices.size
    assert fold_mesh_shape(k, n, b) == (want["fold"], want["data"])
    assert fold_world(k, n, b) == (want["fold"], want["data"], n_eval,
                                   max(want["fold"] * want["data"], n_eval))
    jax_warned = jax_cli.warn_partial_fold_sharding(mesh, k)
    capsys.readouterr()
    assert port_cli.warn_partial_fold_sharding(want["fold"], k) == jax_warned
    assert ("WARNING: only" in capsys.readouterr().out) == jax_warned


def _jax_f2_states():
    from heuristique_style_transfer_code_tpu.config import schema as jschema
    from heuristique_style_transfer_code_tpu.train import factories as jf

    js = jf.setup_gram_attention(jschema.GramAttentionConfig.from_dict(R.F2_CFG.to_dict()), 4,
                                 [(None, None)])
    return js, [js.init(key) for key in jax.random.split(jax.random.PRNGKey(0), 2)]


def _jax_step22(inputs):
    """JAX's fold step on the (fold 2, data 2) mesh from the same trees and
    batches: (losses, fold 0's variables)."""
    from heuristique_style_transfer_code_tpu.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu.parallel.foldparallel import (
        make_fold_mesh,
        make_foldwise_train_step,
        stack_fold_states,
        unstack_fold_state,
    )

    js, states = _jax_f2_states()
    step = make_foldwise_train_step(js._forward_train, js._optimizer,
                                    make_augment_fn([(None, None)], crop=R.CROP),
                                    make_fold_mesh(2, 4, batch_size=R.B))
    sv, _, losses = step(stack_fold_states([v for v, _ in states]),
                         stack_fold_states([o for _, o in states]), inputs["images"][0, :2],
                         inputs["labels"][0, :2], np.zeros((2, R.B), np.int32),
                         jnp.stack(jax.random.split(jax.random.PRNGKey(7), 2)),
                         np.array([True, False]))
    return np.asarray(losses), _flatten(unstack_fold_state(sv, 2)[0])


def _inputs():
    rng = np.random.RandomState(3)
    half = (R.STEPS, 3, R.B // 2, R.STAGE, R.STAGE, 3)
    # each fold's rows split dark / bright: one rank's statistics would miss
    images = np.concatenate([rng.randint(0, 90, half), rng.randint(160, 256, half)],
                            axis=2).astype(np.uint8)
    labels = rng.randint(0, 4, (R.STEPS, 3, R.B)).astype(np.int32)
    labels[0, 0, -1] = -1
    _, states = _jax_f2_states()
    out = {"images": images, "labels": labels}
    for k, (v, _) in enumerate(states):
        out[f"f2_fold{k}"] = jax.tree_util.tree_map(np.array, v)
    return out


def _printed(fn) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tiny_imagefolder, tmp_path_factory):
    """(inputs, the one-device results, every rank's results, the output
    directories, JAX's step, the spawn's seconds). The ranks run while
    this process takes the references."""
    root = tmp_path_factory.mktemp("fold_ranks")
    in_dir, out_dir = str(root / "in"), str(root / "out")
    os.makedirs(in_dir)
    os.makedirs(out_dir)
    save_pytree_npz(_inputs(), os.path.join(in_dir, "inputs.npz"))
    inputs = load_pytree_npz(os.path.join(in_dir, "inputs.npz"))  # the ranks' exact inputs
    with open(os.path.join(in_dir, "cli.json"), "w") as f:
        json.dump(R.CLI_CFG, f)
    spawn = {}

    def ranks_job():
        t0 = time.perf_counter()
        try:
            multihost.launch(R.WORLD, None, [], target=R.rank_main,
                             target_args=(in_dir, out_dir, str(tiny_imagefolder)),
                             rendezvous_dir=str(root), deadline_s=150.0)
        except SystemExit as e:
            spawn["error"] = e
        spawn["seconds"] = time.perf_counter() - t0

    job = threading.Thread(target=ranks_job)
    job.start()
    one = {}
    try:
        one["step22_float64"] = R.fold_steps(None, inputs, "f2", 2, [True, False])
        one["mix14"] = R.mix_case(None, inputs)
        one["jax"] = _jax_step22(inputs)
        one["kfold"] = _printed(lambda: R.kfold_case(None, str(tiny_imagefolder),
                                                     str(root / "one_kfold")))
        from heuristique_style_transfer_code_tpu_torch.cli.train_multi_patchgan import main

        one["cli"] = _printed(lambda: main(R.cli_argv(
            str(tiny_imagefolder), os.path.join(in_dir, "cli.json"), str(root / "one_cli"), 1)))
    finally:
        job.join()
    assert "error" not in spawn, spawn
    ranks = [load_pytree_npz(os.path.join(out_dir, f"rank{r}.npz")) for r in range(R.WORLD)]
    return inputs, one, ranks, root, spawn["seconds"]


def _close(got: dict, want: dict, tol: float, what: str, floor: float = 1e-3) -> None:
    """Every leaf within ``tol`` of ``want``'s, relative L2, the scale at
    least ``floor`` an element (a conv bias ahead of a batch norm has no
    gradient and stays near zero)."""
    got, want = _flatten(got), _flatten(want)
    assert got.keys() == want.keys(), what
    for key in want:
        a, b = np.asarray(got[key], np.float64), np.asarray(want[key], np.float64)
        scale = max(np.linalg.norm(b), floor * np.sqrt(b.size))
        assert np.linalg.norm(a - b) <= tol * scale, (what, key, np.linalg.norm(a - b) / scale)


def _equal(got: dict, want: dict, what: str) -> None:
    got, want = _flatten(got), _flatten(want)
    assert got.keys() == want.keys(), what
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{what} {key}")


def test_step_matches_jax_fold_mesh(runs):
    """The (fold 2, data 2) step in f32 against JAX's on
    ``make_fold_mesh(2, 4, batch_size=8)``, same trees and images, the
    (None, None) augmentation (the packages' draws differ): fold 0's loss
    within 1e-5 relative and its variables at JAX's own rtol 1e-4, atol
    1e-5 (``tests/test_foldparallel.py``)."""
    _, one, ranks, _, _ = runs
    j_losses, j_fold0 = one["jax"]
    got = ranks[0]["step22_float32"]
    assert float(got["loss"][0][0]) == pytest.approx(float(j_losses[0]), rel=1e-5)
    fold0 = _flatten(got["folds"][0])
    assert fold0.keys() == j_fold0.keys()
    for key in j_fold0:
        np.testing.assert_allclose(fold0[key], j_fold0[key], rtol=1e-4, atol=1e-5, err_msg=key)


def test_step_matches_one_device_in_float64(runs):
    """The (fold 2, data 2) step in float64 against the port's one-device
    fold step: the active fold's loss, variables and trace within 1e-10
    (relative L2 a leaf); the inactive fold's variables its start, its
    trace zero and its count 0, bit for bit; every rank holds the same
    states after the broadcast, bit for bit."""
    inputs, one, ranks, _, _ = runs
    want = one["step22_float64"]
    got = ranks[0]["step22_float64"]
    assert float(got["loss"][0][0]) == pytest.approx(float(want["loss"][0][0]), rel=F64_TOL)
    _close(got["folds"][0], want["folds"][0], F64_TOL, "fold 0")
    _close(got["trace"][0], want["trace"][0], F64_TOL, "fold 0 trace", floor=1e-6)
    _equal(got["folds"][1], want["folds"][1], "inactive fold")
    start = {k: np.asarray(v, np.float64) for k, v in _flatten(inputs["f2_fold1"]).items()}
    _equal(got["folds"][1], start, "inactive fold's start")
    assert not any(np.any(v) for v in _flatten(got["trace"][1]).values())
    assert got["count"].tolist() == [1, 0]
    for r in range(1, R.WORLD):
        for part in ("folds", "trace"):
            _equal(ranks[r]["step22_float64"][part], got[part], f"rank {r} {part}")


def test_global_batch_norm_under_vmap_matches_one_device(runs):
    """Three folds of family 3 (batch norms) under mixup on (fold 1, data
    4), two rows a rank: two float64 steps' losses, variables (the running
    statistics with them) and traces within 1e-10 of one device's. Each
    step's all-reduces: the folds' valid counts, two a batch norm forward
    and one backward, each holding all three folds (its size a multiple of
    3), and the gradients with the NLL sums; the norms' vmap rules ran as
    many times forward as backward."""
    _, one, ranks, _, _ = runs
    want, got = one["mix14"], ranks[0]["mix14"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=F64_TOL)
    for k in range(3):
        _close(got["folds"][k], want["folds"][k], F64_TOL, f"fold {k}")
        _close(got["trace"][k], want["trace"][k], F64_TOL, f"fold {k} trace",
               floor=1e-6)
    fwd, bwd = (int(x) for x in got["bn_vmap"])
    assert fwd == bwd > 0 and fwd % R.STEPS == 0
    sizes = got["all_reduce"].reshape(R.STEPS, -1)
    norms = fwd // R.STEPS
    assert sizes.shape[1] == 2 + 3 * norms
    for step in sizes:
        assert step[0] == 3 and all(s % 3 == 0 for s in step[1:-1])
        n_params = sum(np.size(v) for v in _flatten(want["folds"][0]).values())
        assert 3 * norms < step[-1] <= 3 * n_params + 3


def _loss_lines(text: str) -> list:
    return [ln for ln in text.splitlines() if ln.startswith("Fold") and "Loss" in ln]


def _json_close(a, b, what, rel=1e-9):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), what
        for k in a:
            _json_close(a[k], b[k], f"{what}/{k}", rel)
    elif isinstance(a, list):
        assert len(a) == len(b), what
        for x, y in zip(a, b):
            _json_close(x, y, what, rel)
    elif isinstance(a, float):
        assert b == pytest.approx(a, rel=rel, abs=1e-12), what
    else:
        assert a == b, what


def test_run_kfold_on_fold_mesh_matches_one_device(runs):
    """``run_kfold`` (family 3, norm "batch", float64, the clip and the
    EMA; 2 folds of 5 and 6 batches, so fold 0 goes inactive) on a 2 x 2
    fold mesh against one device's ``--parallel_folds``: rank 0 wrote the
    same files, each fold checkpoint's leaves within 1e-10 (relative L2),
    ``training_info.json`` equal (its floats within 1e-9) and the same
    per-batch and per-epoch loss lines in the same order."""
    _, one, _, root, _ = runs
    mine, ref = root / "out" / "kfold", root / "one_kfold"
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    for fold in range(2):
        _close(load_pytree_npz(str(mine / f"best_model_fold_{fold}.npz")),
               load_pytree_npz(str(ref / f"best_model_fold_{fold}.npz")), F64_TOL,
               f"fold {fold}")
    _json_close(json.loads((ref / "training_info.json").read_text()),
                json.loads((mine / "training_info.json").read_text()), "training_info")
    lines = _loss_lines((root / "out" / "rank0_kfold.txt").read_text())
    assert lines == _loss_lines(one["kfold"])
    assert sum("Batch [" in ln for ln in lines) == 11


def test_cli_joins_the_group_and_writes_the_one_device_files(runs):
    """``train_multi_patchgan --parallel_folds --devices 4 --k_folds 2`` in
    each rank, which joins the module's gloo group as under ``torchrun``:
    JAX's mesh line ``{'fold': 2, 'data': 2}`` and no partial-sharding
    warning; rank 0's files those of ``--devices 1`` (f32: every saved
    leaf within 1e-5 relative L2, the scale at least the lr an element,
    the JSON floats within 1e-5) and its training loss lines those of one
    device, in the same order, each loss within one printed unit (1e-4)."""
    _, one, _, root, _ = runs
    out = (root / "out" / "rank0_cli.txt").read_text()
    assert "Fold-parallel training: mesh {'fold': 2, 'data': 2}" in out
    assert "WARNING" not in out
    assert "Fold-parallel training: mesh {'fold': 1, 'data': 1}" in one["cli"]
    mine, ref = root / "out" / "cli", root / "one_cli"
    assert sorted(os.listdir(mine)) == sorted(os.listdir(ref))
    for name in os.listdir(ref):
        if name.endswith(".npz"):
            _close(load_pytree_npz(str(mine / name)), load_pytree_npz(str(ref / name)), F32_TOL,
                   name, floor=R.CLI_CFG["lr"])
        elif name.endswith(".json"):
            a = json.loads((ref / name).read_text().replace(str(ref), "D"))
            b = json.loads((mine / name).read_text().replace(str(mine), "D"))
            _json_close(a, b, name, rel=F32_TOL)
    lines, want = ([ln for ln in _loss_lines(text) if "Epoch [" in ln]
                   for text in (out, one["cli"]))
    assert [ln.split("Loss: ")[0] for ln in lines] == [ln.split("Loss: ")[0] for ln in want]
    for ln, w in zip(lines, want):  # one printed unit: f32 sums in another order
        assert abs(float(ln.split("Loss: ")[1]) - float(w.split("Loss: ")[1])) <= 1e-4, (ln, w)


def test_spawn_budget(runs):
    """The module's one spawn of four ranks, every case run on each, stays
    within the 45 s that this file has in all."""
    assert runs[4] < 45.0
