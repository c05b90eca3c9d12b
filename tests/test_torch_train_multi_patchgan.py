"""Family-3 training in the port against the JAX package, on the CPU:
``avg_pool2d(count_include_pad=False)``, the train-variant discriminator
(logits and updated batch statistics under norm "batch", logits and
gradients under norm "instance", whose norms go through
``InstanceNormFunction``), the weight bridge of its tree both ways, one
SGD step of ``setup_multi_patchgan``'s train step against JAX's, and the
CLI (its flags, its class-count print and its artifact names).

Tolerances, against JAX on the same numpy inputs: avg_pool2d 1e-6 in f32
and one bf16 step (2^-8 relative) in bf16; the model's logits 1e-4 of
their largest magnitude and the running statistics 1e-4 relative in f32;
the input gradient under norm "instance" 1e-4 by relative L2; one train
step: the loss 1e-5 relative and each leaf's move by relative L2 1e-2
(oneDNN's and XLA's convolutions sum in other orders; measured, each
from the same step in float64, at most 2e-3 for the port and 9.5e-4 for
JAX, on the small scale's batch-norm leaves, whose moves are about 5e-5;
below 1e-5 on most leaves), except the biases of the convs that a norm follows, whose true
gradient is 0 (the norm takes the mean out): their moves, rounding noise
in both packages, stay under 1e-6.

Sizes: ndf 8, patch sizes 10/20/10 (2, 3 and 2 strided convs) on 64²
canvases, b3; the train step at patch sizes 10/20/40 on 224² canvases,
since the JAX step crops 224, b2; the CLI at those on the
``tiny_imagefolder`` fixture (24 train images), b4, 2 folds, 1 epoch."""
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
from heuristique_style_transfer_code_tpu_torch.cli.train_multi_patchgan import build_parser, main
from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
    multiscale_apply,
    multiscale_init,
)
from heuristique_style_transfer_code_tpu_torch.ops.conv import avg_pool2d
from heuristique_style_transfer_code_tpu_torch.train.factories import setup_multi_patchgan

SMALL = {"small": 10, "medium": 20, "large": 10}
STEP = {"small": 10, "medium": 20, "large": 40}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,args", [((2, 13, 11, 5), (3, 2, 1, False)),
                                        ((1, 16, 16, 3), (3, 2, 1, False)),
                                        ((2, 9, 7, 4), (3, 2, 1, True)),
                                        ((1, 10, 10, 2), (2, 2, 0, False))])
def test_avg_pool2d_matches_jax(dtype, shape, args):
    from heuristique_style_transfer_code_tpu.ops.conv import avg_pool2d as j_pool

    k, s, p, include = args
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want = np.asarray(j_pool(jnp.asarray(x, jdt), k, s, p, count_include_pad=include), np.float32)
    got = avg_pool2d(torch.from_numpy(x).to(tdt), k, s, p, count_include_pad=include)
    assert got.dtype == tdt and got.shape == want.shape and got.is_contiguous()
    tol = 1e-6 if dtype == "float32" else 2 ** -8
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def _jax_tree(norm, patch_sizes, seed=0):
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import (
        multiscale_init as j_init,
    )

    return jax.tree_util.tree_map(
        np.array, j_init(jax.random.PRNGKey(seed), patch_sizes, ndf=8, num_classes=4, norm=norm))


def _port_model(tree, norm, patch_sizes):
    model = multiscale_init(None, patch_sizes, ndf=8, num_classes=4, norm=norm, device="cpu")
    return load_jax_tree(model, tree)


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_weight_bridge_round_trips_the_train_variant_tree(norm):
    """JAX tree -> port -> JAX tree: the same leaves (a None norm under
    "instance"), the same values."""
    tree = _jax_tree(norm, SMALL)
    back = to_jax_tree(_port_model(tree, norm, SMALL))
    a, b = _flatten(tree), _flatten(back)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]), err_msg=key)
    assert (back["medium"]["convs"][1]["norm"] is None) == (norm == "instance")
    assert (back["large"]["final"]["norm"] is None) == (norm == "instance")
    assert set(back["small"]) == {"convs", "final", "out_conv"}


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_train_forward_matches_jax(norm):
    """Train mode from carried weights: the logits, and under "batch" the
    running statistics every norm updates in place; eval mode's logits
    after it."""
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import (
        multiscale_apply as j_apply,
    )

    tree = _jax_tree(norm, SMALL, seed=1)
    x = np.random.RandomState(2).randn(3, 64, 64, 3).astype(np.float32)
    want, new = jax.jit(lambda v, a: j_apply(v, a, norm=norm, train=True))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    model = _port_model(tree, norm, SMALL)
    with torch.no_grad():
        got = multiscale_apply(model, torch.from_numpy(x), norm, train=True)
    assert model.training
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    stats = _flatten(to_jax_tree(model))
    n_stats = 0
    for key, value in _flatten(jax.tree_util.tree_map(np.asarray, new)).items():
        if key.endswith(("/mean", "/var")):
            np.testing.assert_allclose(stats[key], value, rtol=1e-4, atol=1e-6, err_msg=key)
            n_stats += 1
    assert n_stats == (2 * (3 + 4 + 3) if norm == "batch" else 0)  # 7 strided + 3 final
    want_eval, _ = jax.jit(lambda v, a: j_apply(v, a, norm=norm, train=False))(new,
                                                                              jnp.asarray(x))
    with torch.no_grad():
        got_eval = multiscale_apply(model, torch.from_numpy(x), norm, train=False)
    want_eval = np.asarray(want_eval)
    np.testing.assert_allclose(got_eval.numpy(), want_eval, rtol=0,
                               atol=1e-4 * np.abs(want_eval).max())


def test_instance_norm_gradient_matches_jax():
    """Under norm "instance" the gradient flows through
    ``InstanceNormFunction``'s backward (its plain version on the CPU): the
    input gradient of the summed logits against ``jax.grad``."""
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import (
        multiscale_apply as j_apply,
    )

    tree = _jax_tree("instance", SMALL, seed=3)
    x = np.random.RandomState(4).randn(2, 64, 64, 3).astype(np.float32)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want = np.asarray(jax.jit(jax.grad(lambda v: jnp.sum(j_apply(params, v, norm="instance",
                                                                 train=True)[0])))(
        jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    multiscale_apply(_port_model(tree, "instance", SMALL), xt, "instance", train=True).sum().backward()
    assert _rel_l2(xt.grad.numpy(), want) <= 1e-4


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_train_step_matches_jax(norm):
    """One step of each package's ``setup_multi_patchgan().train_step`` from
    the JAX init: the loss, every leaf's move, the running statistics."""
    from heuristique_style_transfer_code_tpu.config.schema import MultiPatchGANConfig as JConfig
    from heuristique_style_transfer_code_tpu.train.factories import (
        setup_multi_patchgan as j_setup,
    )

    rng = np.random.RandomState(5)
    u8 = rng.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    labels = np.array([3, 1], np.int32)
    kw = dict(batch_size=2, lr=0.05, ndf=8, patch_sizes=STEP, norm=norm)
    js = j_setup(JConfig(**kw), 4, [(None, None)])
    variables, opt = js.init(jax.random.PRNGKey(6))
    tree = jax.tree_util.tree_map(np.array, variables)  # copies: the step donates its inputs
    start = _flatten(tree)
    new_v, _, j_loss = js.train_step(variables, opt, jnp.asarray(u8), jnp.asarray(labels),
                                     jnp.zeros(2, jnp.int32), jax.random.PRNGKey(7))
    want = _flatten(jax.tree_util.tree_map(np.asarray, new_v))
    setup = setup_multi_patchgan(MultiPatchGANConfig(**kw), 4, [(None, None)], device="cpu")
    model, state = setup.init(None)
    load_jax_tree(model, tree)
    _, state, loss = setup.train_step(model, state, u8, labels)
    assert state["count"] == 1
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    got = _flatten(to_jax_tree(model))
    assert got.keys() == want.keys()
    for key in want:
        if key.endswith("__none__"):
            continue
        if key.endswith(("/mean", "/var")):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
        elif key.endswith("conv/bias") and "out_conv" not in key:
            assert np.abs(got[key] - start[key]).max() <= 1e-6, key
            assert np.abs(want[key] - start[key]).max() <= 1e-6, key
        else:
            assert _rel_l2(got[key] - start[key], want[key] - start[key]) <= 1e-2, key


def test_pretrained_tree_is_shape_filtered(tmp_path):
    """``--model_path``: every same-path, same-shape leaf of the checkpoint
    overwrites the fold's fresh init, the rest stays fresh."""
    cfg = MultiPatchGANConfig(batch_size=2, lr=0.1, ndf=8, patch_sizes=SMALL, norm="batch")
    other = to_jax_tree(multiscale_init(torch.Generator().manual_seed(8), SMALL, ndf=8,
                                        num_classes=3, norm="batch", device="cpu"))
    model, _ = setup_multi_patchgan(cfg, 4, [(None, None)], pretrained=other,
                                    device="cpu").init(torch.Generator().manual_seed(9))
    fresh = _flatten(to_jax_tree(multiscale_init(torch.Generator().manual_seed(9), SMALL, ndf=8,
                                                 num_classes=4, norm="batch", device="cpu")))
    got, ckpt = _flatten(to_jax_tree(model)), _flatten(other)
    for key in got:
        same = key in ckpt and np.shape(ckpt[key]) == np.shape(got[key])
        assert np.array_equal(got[key], ckpt[key] if same else fresh[key]), key
    assert not np.array_equal(got["small/out_conv/kernel"], np.zeros(1))  # 3 classes: fresh


# -------------------------------------------------------------------- CLI

CFG = {"batch_size": 4, "lr": 0.01, "ndf": 8, "patch_sizes": STEP, "norm": "instance",
       "num_classes": 7, "seed": 0}
ARTIFACTS = ["best_global_model.npz", "best_global_model_hyperparameters.json",
             "best_model_fold_0.npz", "best_model_fold_0_hyperparameters.json",
             "best_model_fold_1.npz", "best_model_fold_1_hyperparameters.json",
             "best_model_results.json", "events.jsonl", "fold_0_performance.json",
             "fold_1_performance.json", "model_fold_0.npz", "model_fold_0_hyperparameters.json",
             "model_fold_1.npz", "model_fold_1_hyperparameters.json",
             "retrained_hyperparameters.json", "retrained_performance.json",
             "training_info.json"]


FOLD_MODEL = "model_fold_0.npz"
ONE_EPOCH = ()

@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("f3train") / "cfg.json"
    with open(path, "w") as f:
        json.dump(CFG, f)
    return str(path)


def _args(folder, cfg, save_dir, *extra):
    return ["--data", str(folder), "--config_path", cfg, "--epochs", "1", "--save_dir",
            str(save_dir), "--device", "cpu", *extra]


def test_cli_writes_the_jax_artifacts(tiny_imagefolder, cfg_path, tmp_path, capsys):
    """The JAX CLI's files (``model_fold_<k>``, the two ``retrained_*``
    files and the k-fold set), the class count from the folder (4, not
    the config's 7), the split of seed 42, and a checkpoint the JAX
    package's reader and train-variant forward take."""
    from heuristique_style_transfer_code_tpu.cli._common import load_checkpoint_tree as j_load
    from heuristique_style_transfer_code_tpu.models.multi_patchgan import (
        multiscale_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.train.kfold import kfold_split

    main(_args(tiny_imagefolder, cfg_path, tmp_path))
    out = capsys.readouterr().out
    assert "Nombre de classes détecté : 4" in out
    assert f"Fold 1: Poids du modèle sauvegardés à {tmp_path / 'model_fold_1.npz'}" in out
    assert sorted(os.listdir(tmp_path)) == ARTIFACTS
    with open(tmp_path / "retrained_hyperparameters.json") as f:
        hp = json.load(f)
    assert hp["num_classes"] == 4 and hp["patch_sizes"] == STEP and hp["norm"] == "instance"
    with open(tmp_path / "retrained_performance.json") as f:
        perf = json.load(f)
    assert [r["fold"] for r in perf] == [0, 1]
    with open(tmp_path / "fold_1_performance.json") as f:
        assert json.load(f) == perf[1]
    with open(tmp_path / "training_info.json") as f:
        assert json.load(f)["num_folds"] == 2
    val = [len(v) for _, v in kfold_split(24, 2, 42)]
    assert val == [12, 12]
    path = str(tmp_path / "model_fold_0.npz")
    tree = j_load(path, "multi_patchgan", hp)
    x = np.random.RandomState(10).randn(1, 192, 192, 3).astype(np.float32)
    want, _ = jax.jit(lambda v, a: j_apply(v, a, norm="instance"))(tree, jnp.asarray(x))
    model = _port_model(jax.tree_util.tree_map(np.asarray, tree), "instance", STEP)
    with torch.no_grad():
        got = multiscale_apply(model, torch.from_numpy(x), "instance", train=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(want)).max())


def test_cli_loads_a_checkpoint_shape_filtered(tiny_imagefolder, cfg_path, tmp_path, capsys):
    path = str(tmp_path / "init.npz")
    save_pytree_npz(to_jax_tree(multiscale_init(None, STEP, ndf=8, num_classes=4,
                                                norm="instance", device="cpu")), path)
    main(_args(tiny_imagefolder, cfg_path, tmp_path / "out", "--model_path", path))
    assert f"Poids du modèle chargés depuis {path} (shape-filtered)" in capsys.readouterr().out


def test_parser_has_every_jax_flag():
    from heuristique_style_transfer_code_tpu.cli.train_multi_patchgan import (
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
    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_multi_patchgan

    def args_fn(save_dir, *extra, config=cfg_path):
        return _args(tiny_imagefolder, config, save_dir, *ONE_EPOCH, *extra)

    def make_setup(cfg):
        return setup_multi_patchgan(MultiPatchGANConfig.from_dict(cfg), 4, [(None, None)],
                                    device="cpu")

    check_flag_run(main, args_fn, tmp_path / "out", one_epoch_run, extra, dict(CFG, num_classes=4),
                   FOLD_MODEL, make_setup, capsys, tmp_path)
