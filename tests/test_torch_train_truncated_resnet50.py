"""Family-1 training in the port against the JAX package, on the CPU: the
train-mode forward, one SGD step of ``setup_truncated_resnet50``'s train
step (identity combination) against JAX's from the same weights and
batch, ``--freeze_encoder``, the CLI's flags and per-fold load messages
against the JAX CLI's, its artifacts, and a resumed run with
augmentation bit-identical to an uninterrupted one.

Tolerances, against JAX on the same numpy inputs, f32: the loss 1e-5
relative; each updated leaf's move (after - before) by relative L2: 1e-4
for the heads (the MoCo fc and the classifier; measured 3e-6) and 1e-2
for the encoder's leaves (oneDNN's and XLA's convolutions sum in other
orders, and at truncate 5 the batch norms of layer1 amplify it: measured
4e-3 for the port and 1.6e-3 for JAX, each from the same step in float64);
the running statistics 1e-4 relative.

Sizes: truncate 4 and 5, dim 16, 4 classes; the step at b4 on 224²
canvases, since the JAX step crops 224; the CLI at truncate 4 on the
``tiny_imagefolder`` fixture (24 train images), b4, 2 folds."""
import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from tests.torch_train_flags import FLAG_CASES, check_flag_run

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    _flatten,
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.cli.train_truncated_resnet50 import (
    build_parser,
    main,
)
from heuristique_style_transfer_code_tpu_torch.config.schema import TruncatedResNetConfig
from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
    truncated_resnet50_init,
)
from heuristique_style_transfer_code_tpu_torch.train import kfold as pk
from heuristique_style_transfer_code_tpu_torch.train import preemption
from heuristique_style_transfer_code_tpu_torch.train.factories import setup_truncated_resnet50


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("truncate", [4, 5])
def test_train_step_matches_jax(truncate):
    """One step of each package's ``setup_truncated_resnet50().train_step``
    from the JAX init: the loss, every leaf's move and the running
    statistics."""
    from heuristique_style_transfer_code_tpu.config.schema import (
        TruncatedResNetConfig as JConfig,
    )
    from heuristique_style_transfer_code_tpu.train.factories import (
        setup_truncated_resnet50 as j_setup,
    )

    rng = np.random.RandomState(7)
    u8 = rng.randint(0, 256, (4, 224, 224, 3)).astype(np.uint8)
    labels = np.array([2, 0, -1, 3], np.int32)  # one pad entry
    jcfg = JConfig(batch_size=4, lr=0.05, truncate_layer=truncate, dim=16)
    js = j_setup(jcfg, 4, [(None, None)])
    variables, opt = js.init(jax.random.PRNGKey(3))
    tree = jax.tree_util.tree_map(np.array, variables)  # copies: the step donates its inputs
    start = _flatten(tree)
    new_v, _, j_loss = js.train_step(variables, opt, jnp.asarray(u8), jnp.asarray(labels),
                                     jnp.zeros(4, jnp.int32), jax.random.PRNGKey(4))
    want = _flatten(jax.tree_util.tree_map(np.asarray, new_v))

    cfg = TruncatedResNetConfig(batch_size=4, lr=0.05, truncate_layer=truncate, dim=16)
    setup = setup_truncated_resnet50(cfg, 4, [(None, None)], device="cpu")
    model, state = setup.init(None)
    load_jax_tree(model, tree)
    _, state, loss = setup.train_step(model, state, u8, labels)
    assert state["count"] == 1
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    got = _flatten(to_jax_tree(model))
    assert got.keys() == want.keys()
    for key in want:
        if key.endswith(("/mean", "/var")):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
        else:
            tol = 1e-2 if key.startswith("moco/encoder") else 1e-4
            assert _rel_l2(got[key] - start[key], want[key] - start[key]) <= tol, key


def test_freeze_encoder_trains_only_the_classifier():
    """``--freeze_encoder``: every ``moco`` parameter stays (its running
    statistics move), the classifier trains."""
    cfg = TruncatedResNetConfig(batch_size=4, lr=0.1, truncate_layer=5, dim=16)
    setup = setup_truncated_resnet50(cfg, 4, [(None, None)], freeze_encoder=True, device="cpu")
    model, state = setup.init(torch.Generator().manual_seed(0))
    assert sorted({n.split(".")[0] for n in state["trace"]}) == ["classifier"]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    u8 = np.random.RandomState(5).randint(0, 256, (4, 224, 224, 3)).astype(np.uint8)
    setup.train_step(model, state, u8, np.array([0, 1, 2, 3], np.int32))
    for key, v in model.state_dict().items():
        moved = not torch.equal(v, before[key])
        if key.startswith("moco"):
            assert moved == key.endswith(("running_mean", "running_var")), key
        else:
            assert moved, key


def test_pretrained_tree_loads_whole_or_encoder_only():
    """A ``{moco, classifier}`` tree loads whole; a ``{moco}`` one beside
    the fold's fresh classifier; a tree of another truncation is refused."""
    cfg = TruncatedResNetConfig(batch_size=4, lr=0.1, truncate_layer=4, dim=16)
    tree = to_jax_tree(truncated_resnet50_init(torch.Generator().manual_seed(1), 4, 4, 16,
                                                 device="cpu"))
    whole = setup_truncated_resnet50(cfg, 4, [(None, None)], pretrained=tree, device="cpu")
    model, _ = whole.init(torch.Generator().manual_seed(2))
    got = _flatten(to_jax_tree(model))
    ref = _flatten(tree)
    assert all(np.array_equal(got[k], ref[k]) for k in got)
    enc = setup_truncated_resnet50(cfg, 4, [(None, None)], pretrained={"moco": tree["moco"]},
                                   device="cpu")
    model, _ = enc.init(torch.Generator().manual_seed(2))
    got = _flatten(to_jax_tree(model))
    fresh = _flatten(to_jax_tree(truncated_resnet50_init(torch.Generator().manual_seed(2), 4, 4,
                                                         16, device="cpu")))
    for k in got:
        assert np.array_equal(got[k], ref[k] if k.startswith("moco") else fresh[k]), k
    other = to_jax_tree(truncated_resnet50_init(None, 5, 4, 16, device="cpu"))
    with pytest.raises(KeyError, match="weight bridge"):
        setup_truncated_resnet50(cfg, 4, [(None, None)], pretrained=other,
                                 device="cpu").init(None)


# -------------------------------------------------------------------- CLI

CFG = {"batch_size": 4, "lr": 0.01, "truncate_layer": 4, "dim": 16, "seed": 0}
AUG = ("--geom_aug", "--geom_transforms", "rotation", "--color_aug",
       "--num_color_transforms", "1")
ARTIFACTS = ["best_global_model.npz", "best_global_model_hyperparameters.json",
             "best_model_fold_0.npz", "best_model_fold_0_hyperparameters.json",
             "best_model_fold_1.npz", "best_model_fold_1_hyperparameters.json",
             "best_model_results.json", "events.jsonl", "fold_0_performance.json",
             "fold_1_performance.json", "training_info.json"]


FOLD_MODEL = "best_model_fold_0.npz"
ONE_EPOCH = ("--epochs", "1")

@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("f1train") / "cfg.json"
    with open(path, "w") as f:
        json.dump(CFG, f)
    return str(path)


def _args(folder, cfg, save_dir, *extra, epochs=2):
    return ["--data", str(folder), "--config_path", cfg, "--k_folds", "2", "--epochs",
            str(epochs), "--save_dir", str(save_dir), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def port_run(tiny_imagefolder, cfg_path, tmp_path_factory):
    """The CLI once with augmentation, uninterrupted: its artifact directory."""
    out = tmp_path_factory.mktemp("port_f1train")
    main(_args(tiny_imagefolder, cfg_path, out, *AUG))
    return out


def test_cli_writes_the_jax_artifacts(port_run):
    """The JAX CLI's file set (``run_kfold``'s, with no per-fold extras for
    family 1), its checkpoints in the JAX layout: the JAX package's eval
    forward reads ``best_global_model.npz``."""
    from heuristique_style_transfer_code_tpu.checkpoint.io import load_pytree_npz as j_load
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
        combined_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.cli._common import load_truncated_resnet50
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply,
    )

    assert sorted(os.listdir(port_run)) == ARTIFACTS
    with open(port_run / "training_info.json") as f:
        info = json.load(f)
    assert info["num_folds"] == 2 and len(info["fold_results"]) == 2
    path = str(port_run / "best_global_model.npz")
    tree = j_load(path)
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    want, _ = j_apply(tree["moco"], tree["classifier"], jnp.asarray(x), 4)
    model = load_truncated_resnet50(path, 4, torch.device("cpu"))
    with torch.no_grad():
        got = combined_apply(model.moco, model.classifier, torch.from_numpy(x), 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _preempt_after(monkeypatch, n):
    calls = {"n": 0}

    def fake():
        calls["n"] += 1
        return calls["n"] > n

    monkeypatch.setattr(preemption, "preemption_requested", fake)


@pytest.mark.parametrize("checks,extra", [(4, ()), (8, ("--async_checkpoint",))])
def test_resume_with_augmentation_is_bit_identical(tiny_imagefolder, cfg_path, port_run,
                                                   tmp_path, monkeypatch, capsys, checks,
                                                   extra):
    """Preempted before the 5th step (fold 0, epoch 2) or the 9th (fold 1,
    epoch 1), then the same command: every checkpoint and fold result
    equals the uninterrupted run's, augmentation draws included."""
    args = _args(tiny_imagefolder, cfg_path, tmp_path, *AUG, "--resume", *extra)
    _preempt_after(monkeypatch, checks)
    main(args)
    assert "Preempted: preempted: progress through epoch" in capsys.readouterr().out
    assert (tmp_path / pk._INPROGRESS_STATE).exists()
    monkeypatch.undo()
    main(args)
    assert "Resuming from fold" in capsys.readouterr().out
    for name in ("best_global_model.npz", "best_model_fold_0.npz", "best_model_fold_1.npz"):
        a = _flatten(load_pytree_npz(str(port_run / name)))
        b = _flatten(load_pytree_npz(str(tmp_path / name)))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {key}")
    for name in ("fold_0_performance.json", "fold_1_performance.json"):
        with open(port_run / name) as f, open(tmp_path / name) as g:
            assert json.load(f) == json.load(g)


def test_resume_under_other_augmentation_is_refused(tiny_imagefolder, cfg_path, tmp_path,
                                                    monkeypatch):
    _preempt_after(monkeypatch, 4)  # one epoch on disk
    main(_args(tiny_imagefolder, cfg_path, tmp_path, *AUG, "--resume"))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="does not match"):
        main(_args(tiny_imagefolder, cfg_path, tmp_path, "--geom_aug", "--geom_transforms",
                   "affine", "--resume"))


def _fold_lines(run, monkeypatch, capsys, kfold_module, call_init):
    """The "Fold 0: ..." lines a CLI prints as its first fold starts, its
    k-fold loop stubbed to call ``init_fn`` once."""
    monkeypatch.setattr(kfold_module, "run_kfold", lambda *a, init_fn, **k: call_init(init_fn))
    capsys.readouterr()
    run()
    return [line for line in capsys.readouterr().out.splitlines() if line.startswith("Fold 0:")]


@pytest.mark.parametrize("variant", ["none", "whole", "mismatch", "no_classifier", "frozen"])
def test_fold_load_messages_match_the_jax_cli(variant, tiny_imagefolder, cfg_path, tmp_path,
                                              monkeypatch, capsys):
    """Each fold's checkpoint message, word for word, and the
    ``--freeze_encoder`` line, as the JAX CLI prints them."""
    from heuristique_style_transfer_code_tpu.cli import train_truncated_resnet50 as jcli

    tree = None
    if variant in ("whole", "frozen", "mismatch", "no_classifier"):
        classes = 3 if variant == "mismatch" else 4
        tree = to_jax_tree(truncated_resnet50_init(torch.Generator().manual_seed(0), 4, classes,
                                                   16, device="cpu"))
        if variant == "no_classifier":
            tree = {"moco": tree["moco"]}
    extra = ["--freeze_encoder"] if variant == "frozen" else []
    if tree is not None:
        path = str(tmp_path / "ckpt.npz")
        save_pytree_npz(tree, path)
        extra += ["--model_path", path]
    base = ["--data", str(tiny_imagefolder), "--config_path", cfg_path, "--k_folds", "2",
            "--save_dir", str(tmp_path / "out"), *extra]
    want = _fold_lines(lambda: jcli.main(base), monkeypatch, capsys, jcli,
                       lambda init_fn: init_fn(jax.random.PRNGKey(0), 0))
    got = _fold_lines(lambda: main(base + ["--device", "cpu"]), monkeypatch, capsys, pk,
                      lambda init_fn: init_fn(0))
    assert got == want and len(want) == (2 if variant == "frozen" else 1)


def test_parser_has_every_jax_flag():
    from heuristique_style_transfer_code_tpu.cli.train_truncated_resnet50 import (
        build_parser as j_parser,
    )

    def flags(parser):
        return {a.option_strings[0]: (a.default, a.choices) for a in parser._actions
                if a.option_strings and a.dest != "help"}

    want, got = flags(j_parser()), flags(build_parser())
    assert set(got) - set(want) == {"--device"}
    assert {k: got[k] for k in want} == want


@pytest.mark.parametrize("extra", [
    # --zero1 and --devices now run (tests/test_torch_data_parallel.py), as
    # does --parallel_folds with --devices (tests/test_torch_fold_ranks.py):
    # with orbax the launching process still refuses before it starts any rank
    ("--zero1", "--checkpoint_format", "orbax"), ("--parallel_folds", "--devices", "2",
                                                  "--checkpoint_format", "orbax"),
    ("--devices", "2", "--checkpoint_format", "orbax"), ("--checkpoint_format", "orbax")])
def test_unported_flags_raise(tiny_imagefolder, cfg_path, tmp_path, extra):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        main(_args(tiny_imagefolder, cfg_path, tmp_path, *extra))


@pytest.fixture(scope="module")
def one_epoch_run(tiny_imagefolder, cfg_path, tmp_path_factory):
    """The port's CLI for one epoch, no flag: (its directory, its per-batch
    loss lines)."""
    out = tmp_path_factory.mktemp("plain_one_epoch")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        main(_args(tiny_imagefolder, cfg_path, out, *ONE_EPOCH))
    return out, [line for line in printed.getvalue().splitlines() if "Batch [" in line]


@pytest.mark.parametrize("extra", [
    ("--remat",), ("--steps_per_dispatch", "2"), ("--profile_dir", "PROFILE"), ("--debug_nans",),
    ("--grad_accum", "2")])
def test_flags_ported_in_this_slice_run(tiny_imagefolder, cfg_path, tmp_path, one_epoch_run,
                                        extra, capsys):
    """``--remat``, ``--steps_per_dispatch 2`` (an epoch's 3 batches: a
    chunk of 2, a tail of 1), ``--profile_dir`` and ``--debug_nans`` give the plain
    run's fold checkpoint and per-batch losses bit for bit on the CPU (the
    same ops; remat's recompute updates no running statistic twice);
    the profile's Chrome trace is in its directory. ``--grad_accum 2``
    prints the JAX CLI's line and trains (its numbers are held against
    JAX in ``test_torch_dispatch_accum.py``)."""
    extra = tuple(str(tmp_path / "prof") if e == "PROFILE" else e for e in extra)
    plain, plain_lines = one_epoch_run
    main(_args(tiny_imagefolder, cfg_path, tmp_path / "out", *ONE_EPOCH, *extra))
    printed = capsys.readouterr().out
    got, want = (load_pytree_npz(str(d / FOLD_MODEL)) for d in (tmp_path / "out", plain))
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    if extra[0] == "--grad_accum":
        assert "Gradient accumulation: 2 micro-batches of 2 per optimiser step" in printed
        assert all(np.isfinite(v).all() for v in got.values())
        return
    assert [line for line in printed.splitlines() if "Batch [" in line] == plain_lines
    assert all(np.array_equal(got[k], want[k]) for k in want)
    if extra[0] == "--profile_dir":
        assert any(n.endswith(".pt.trace.json") for n in os.listdir(tmp_path / "prof"))


def test_cli_without_device_cpu_raises_on_a_host_without_cuda(tiny_imagefolder, cfg_path,
                                                                tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(_args(tiny_imagefolder, cfg_path, tmp_path)[:-2])


@pytest.mark.parametrize("extra", FLAG_CASES)
def test_ema_mixing_and_auto_batch_flags_run(tiny_imagefolder, cfg_path, tmp_path,
                                             one_epoch_run, extra, capsys):
    """``--ema_decay``, ``--mixup``, ``--cutmix``, ``--auto_batch`` with
    ``--hbm_budget_gb`` and ``--hbm_budget_gb`` alone through the CLI,
    against its plain run (``tests/torch_train_flags.py`` says what each
    case holds; the numbers are held against JAX in
    ``test_torch_ema.py``, ``test_torch_mixing.py`` and
    ``test_torch_autotune.py``)."""
    from heuristique_style_transfer_code_tpu_torch.config.schema import TruncatedResNetConfig
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_truncated_resnet50

    def args_fn(save_dir, *extra, config=cfg_path):
        return _args(tiny_imagefolder, config, save_dir, *ONE_EPOCH, *extra)

    def make_setup(cfg):
        return setup_truncated_resnet50(TruncatedResNetConfig.from_dict(cfg), 4, [(None, None)],
                                        device="cpu")

    check_flag_run(main, args_fn, tmp_path / "out", one_epoch_run, extra, CFG,
                   FOLD_MODEL, make_setup, capsys, tmp_path)
