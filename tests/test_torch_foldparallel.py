"""``--parallel_folds`` in the port (``parallel/foldparallel.py``): every
fold's train step as one ``vmap(grad(...))`` program on one device, held
against the JAX package's fold-parallel step and against the port's own
sequential loop, on the CPU.

- One fold-parallel step of families 1-3 (family 3 under norm "instance",
  so K3 and K3′ run under the transform) from the same stacked weights
  and batches as JAX's ``make_foldwise_train_step``, with fold 1
  inactive: the active fold's variables at JAX's own tolerance
  (``tests/test_foldparallel.py``: rtol 1e-4, atol 1e-5) and its loss at
  1e-5 relative; the inactive fold's parameters, buffers and optimiser
  state unchanged bit for bit.
- ``run_kfold`` with and without ``foldwise_step`` (family 3, norm
  "instance", three folds of unequal batch counts, so a fold goes
  inactive, in float64): every fold's checkpoint at rtol 1e-4, atol 1e-5
  and its validation results to 1e-9.
- The three train CLIs run the flag; the exclusions refuse with the JAX
  CLI's messages, and ``--devices 2`` runs the folds on two gloo ranks.

Sizes: truncations 5 and 6, 32- and 48-pixel crops, b4, two folds; the
run_kfold at 224² (the CLI's crop) with ndf 8 and b2."""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz
from heuristique_style_transfer_code_tpu_torch.config.schema import (
    GramAttentionConfig,
    MultiPatchGANConfig,
    TruncatedResNetConfig,
)
from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
from heuristique_style_transfer_code_tpu_torch.parallel import foldparallel as fp
from heuristique_style_transfer_code_tpu_torch.train import factories as pf
from heuristique_style_transfer_code_tpu_torch.train.kfold import run_kfold

SMALL = {"small": 10, "medium": 20, "large": 10}
FAMILIES = {
    # family: (port config, JAX setup name, crop)
    "family1": (TruncatedResNetConfig(batch_size=4, lr=0.01, truncate_layer=5, dim=16),
                "setup_truncated_resnet50", 32),
    "family2": (GramAttentionConfig(batch_size=4, lr=0.01, truncate_layer=6,
                                    gram_matrix_size=4), "setup_gram_attention", 32),
    "family3": (MultiPatchGANConfig(batch_size=4, lr=0.01, ndf=8, patch_sizes=SMALL,
                                    norm="instance"), "setup_multi_patchgan", 48),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port_setup(family, cfg, **kw):
    fn = {"family1": pf.setup_truncated_resnet50, "family2": pf.setup_gram_attention,
          "family3": pf.setup_multi_patchgan}[family]
    return fn(cfg, 4, [(None, None)], device="cpu", **kw)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_foldwise_step_matches_jax(family):
    from heuristique_style_transfer_code_tpu.config import schema as jschema
    from heuristique_style_transfer_code_tpu.data.augment import make_augment_fn as j_aug
    from heuristique_style_transfer_code_tpu.parallel.foldparallel import (
        make_fold_mesh,
        make_foldwise_train_step,
        stack_fold_states,
        unstack_fold_state,
    )
    from heuristique_style_transfer_code_tpu.train import factories as jf

    cfg, j_name, crop = FAMILIES[family]
    j_cfg = getattr(jschema, type(cfg).__name__).from_dict(cfg.to_dict())
    js = getattr(jf, j_name)(j_cfg, 4, [(None, None)])
    states = [js.init(k) for k in jax.random.split(jax.random.PRNGKey(0), 2)]
    trees = [jax.tree_util.tree_map(np.array, v) for v, _ in states]  # the step donates
    rng = np.random.RandomState(1)
    images = rng.randint(0, 256, (2, 4, crop + 8, crop + 8, 3), dtype=np.uint8)
    labels = np.array([[0, 3, -1, 2], [1, 1, 2, 0]], np.int32)
    combos = np.zeros((2, 4), np.int32)
    j_step = make_foldwise_train_step(js._forward_train, js._optimizer,
                                      j_aug([(None, None)], crop=crop), make_fold_mesh(2, 1))
    sv, _, j_losses = j_step(stack_fold_states([v for v, _ in states]),
                             stack_fold_states([o for _, o in states]), images, labels, combos,
                             jnp.stack(jax.random.split(jax.random.PRNGKey(7), 2)),
                             np.array([True, False]))
    want = _flatten(unstack_fold_state(sv, 2)[0])

    ps = _port_setup(family, cfg)
    port = []
    for tree in trees:
        model, _ = ps.init(None)
        load_jax_tree(model, tree)
        port.append((model, ps.optimizer[0](model)))
    start = {k: v.clone() for k, v in port[1][0].state_dict().items()}
    step = fp.make_foldwise_train_step(ps._forward_train, ps.optimizer,
                                       make_augment_fn([(None, None)], crop=crop))
    stacked = fp.stack_fold_states(port)
    batches = [{"image": images[k], "label": labels[k], "combo": None, "draws": None}
               for k in range(2)]
    losses = step(stacked, batches, [True, False])
    fp.unstack_fold_state(stacked, port)

    assert float(losses[0]) == pytest.approx(float(j_losses[0]), rel=1e-5)
    got = _flatten(to_jax_tree(port[0][0]))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)
    model, opt = port[1]
    assert all(torch.equal(t, start[k]) for k, t in model.state_dict().items())
    assert opt["count"] == 0 and all(not t.any() for t in opt["trace"].values())
    assert port[0][1]["count"] == 1


def _family3_f64_setup(batch_size):
    cfg = MultiPatchGANConfig(batch_size=batch_size, lr=0.05, ndf=8, patch_sizes=SMALL,
                              norm="instance")
    setup = _port_setup("family3", cfg, compute_dtype=torch.float64, clip_norm=0.5,
                        ema_decay=0.9)

    def init_fn(fold):
        model, _ = setup.init(torch.Generator().manual_seed(fold))
        model = model.double()
        return model, setup.optimizer[0](model), setup.train_step, setup.eval_step

    return setup, init_fn


def test_run_kfold_parallel_matches_sequential(tiny_imagefolder, tmp_path):
    """Three folds of 22 samples at b2: 7, 8 and 8 train batches, so fold 0
    is inactive in the epoch's last round; with the clip and the EMA."""
    dataset = ImageFolderIndex(str(tiny_imagefolder / "train"))
    dataset.samples = dataset.samples[:22]
    runs = {}
    for name in ("sequential", "parallel"):
        setup, init_fn = _family3_f64_setup(2)
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            info = run_kfold(dataset, k_folds=3, seed=0, epochs=1, batch_size=2,
                             save_dir=str(tmp_path / name), hyperparameters={"lr": 0.05},
                             init_fn=init_fn, eval_variables_fn=lambda m, o: m,
                             foldwise_step=setup.foldwise_step() if name == "parallel" else None)
        lines = sorted(ln for ln in printed.getvalue().splitlines() if "Batch [" in ln)
        runs[name] = (info, lines)
    (seq, seq_lines), (par, par_lines) = runs["sequential"], runs["parallel"]
    assert len(seq_lines) == len(par_lines) == 23
    assert [ln.split(", Loss")[0] for ln in seq_lines] == [
        ln.split(", Loss")[0] for ln in par_lines]
    for a, b in zip(seq["fold_results"], par["fold_results"]):
        assert a.keys() == b.keys()
        for key in a:
            assert a[key] == pytest.approx(b[key], rel=1e-9, abs=1e-12), key
    for fold in range(3):
        want, got = (_flatten(load_pytree_npz(str(tmp_path / name / f"best_model_fold_{fold}.npz")))
                     for name in ("sequential", "parallel"))
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-5, err_msg=key)


def test_inactive_fold_keeps_momentum_and_statistics():
    """A fold inactive in a round keeps its parameters, running statistics,
    trace, EMA and count exactly; the active one moves all of them."""
    setup = _port_setup("family2", FAMILIES["family2"][0], ema_decay=0.9)
    states = [setup.init(torch.Generator().manual_seed(k)) for k in range(2)]
    step = fp.make_foldwise_train_step(setup._forward_train, setup.optimizer,
                                       make_augment_fn([(None, None)], crop=32))
    stacked = fp.stack_fold_states(states)
    rng = np.random.RandomState(2)
    batch = {"image": rng.randint(0, 256, (4, 40, 40, 3), dtype=np.uint8),
             "label": np.array([0, 1, 2, 3], np.int32)}
    step(stacked, [batch, batch], [True, True])
    before = {part: {n: t.clone() for n, t in stacked[part].items()}
              for part in ("params", "buffers", "trace", "ema")}
    step(stacked, [batch, batch], [False, True])
    assert stacked["count"] == [1, 2]
    for part, tensors in before.items():
        for n, t in tensors.items():
            assert torch.equal(stacked[part][n][0], t[0]), (part, n)
    for part in ("params", "trace", "ema"):
        assert any(not torch.equal(stacked[part][n][1], t[1]) for n, t in before[part].items())
    moved = [n for n, t in before["buffers"].items() if not torch.equal(stacked["buffers"][n][1],
                                                                       t[1])]
    assert moved


CLIS = {
    "family1": ("train_truncated_resnet50",
                {"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "dim": 16, "seed": 0}),
    "family2": ("train_gram_attention",
                {"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "gram_matrix_size": 4,
                 "seed": 0}),
    "family3": ("train_multi_patchgan",
                {"batch_size": 4, "lr": 0.01, "ndf": 8, "patch_sizes": SMALL,
                 "norm": "instance", "seed": 0}),
}


def _cli(family, folder, tmp_path, *extra):
    import importlib

    name, cfg = CLIS[family]
    path = tmp_path / f"{family}.json"
    path.write_text(json.dumps(cfg))
    main = importlib.import_module(f"heuristique_style_transfer_code_tpu_torch.cli.{name}").main
    return main(["--data", str(folder), "--config_path", str(path), "--k_folds", "2",
                 "--epochs", "1", "--save_dir", str(tmp_path / "out"), "--device", "cpu",
                 *extra])


@pytest.mark.parametrize("family", sorted(CLIS))
def test_cli_runs_parallel_folds(family, tiny_imagefolder, tmp_path, capsys):
    """Each train CLI under ``--parallel_folds``: the JAX CLI's lines (the
    1 x 1 mesh and its partial-sharding warning), the per-fold batch lines
    interleaved in fold order, and every fold's artifacts."""
    _cli(family, tiny_imagefolder, tmp_path, "--parallel_folds")
    out = capsys.readouterr().out
    assert "Fold-parallel training: mesh {'fold': 1, 'data': 1}" in out
    assert "WARNING: only 1 of 2 folds shard onto devices" in out
    batch_lines = [ln.split(",")[0] for ln in out.splitlines() if "Batch [" in ln]
    assert batch_lines[:4] == ["Fold 0", "Fold 1", "Fold 0", "Fold 1"]
    for fold in range(2):
        got = _flatten(load_pytree_npz(str(tmp_path / "out" / f"best_model_fold_{fold}.npz")))
        assert all(np.isfinite(v).all() for v in got.values())
    assert json.loads((tmp_path / "out" / "training_info.json").read_text())["num_folds"] == 2


@pytest.mark.parametrize("extra,error,message", [
    (("--resume",), ValueError, "fold-parallel training does not support --resume"),
    (("--steps_per_dispatch", "2"), ValueError,
     "fold-parallel training and --steps_per_dispatch are exclusive"),
    (("--zero1",), SystemExit, "--parallel_folds and --zero1 are exclusive"),
    (("--early_stop", "1"), SystemExit, "--parallel_folds and --early_stop are exclusive"),
    (("--grad_accum", "2"), SystemExit, "--grad_accum and --parallel_folds are exclusive"),
    (("--auto_batch",), SystemExit, "--auto_batch is exclusive with --grad_accum>1 and "
                                    "--parallel_folds"),
    (("--remat",), SystemExit, "--parallel_folds and --remat are exclusive"),
    (("--devices", "2"), None, "Fold-parallel training: mesh {'fold': 2, 'data': 1}"),
])
def test_exclusions(extra, error, message, tiny_imagefolder, tmp_path, capfd):
    """Each exclusion refuses with the JAX CLI's message (family 1);
    ``--devices 2`` runs (family 3, the cheapest step): two gloo ranks,
    one fold each (a 2 x 1 fold mesh), rank 0 printing the mesh line and
    every fold's lines and writing every fold's artifacts."""
    if error is not None:
        with pytest.raises(error, match=message.replace("+", r"\+")):
            _cli("family1", tiny_imagefolder, tmp_path, "--parallel_folds", *extra)
        return
    _cli("family3", tiny_imagefolder, tmp_path, "--parallel_folds", *extra)
    out = capfd.readouterr().out
    assert message in out and "WARNING" not in out
    assert "--parallel_folds over 2 ranks (gloo): fold 2 x data 1, evaluation on the first 2" \
        in out
    assert [ln.split(",")[0] for ln in out.splitlines() if "Batch [" in ln][:2] == [
        "Fold 0", "Fold 1"]
    for fold in range(2):
        got = _flatten(load_pytree_npz(str(tmp_path / "out" / f"best_model_fold_{fold}.npz")))
        assert all(np.isfinite(v).all() for v in got.values())
    info = json.loads((tmp_path / "out" / "training_info.json").read_text())
    assert [r["fold"] for r in info["fold_results"]] == [0, 1]
