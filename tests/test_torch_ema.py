"""``--ema_decay``: the port's parameter EMA (``train/optim.py``) against
the JAX package's ``param_ema`` (``sgd_momentum(ema_decay=)``,
``extract_ema_variables``), on the CPU, and its path through ``run_kfold``
and the family-2 train CLI.

- Three SGD updates from the same weights and gradients (a toy tree with
  every leaf kind of the family-2 tree, with and without a frozen
  encoder): the EMA of every trainable leaf within 1e-6 relative of
  JAX's; the evaluation tree takes the batch-norm running statistics from
  the live model (set to new values after the steps, as a forward would);
  a frozen leaf's EMA is its init, bit for bit here (the state keeps none
  for it) and within 1e-6 in JAX (whose f32 average of a constant
  rounds);
- a decay of 0, 1 or outside (0, 1) raises JAX's ValueError;
- without the flag the state has no EMA and evaluation takes the model
  itself;
- the CLI with ``--ema_decay 0.9 --resume`` stopped before its 5th step:
  the in-progress file carries the EMA in the JAX layout, and the resumed
  run's artifacts equal an uninterrupted run's bit for bit;
- every fold checkpoint is the EMA tree that ``extract_ema_variables``
  gave at the fold's end, bit for bit.

Sizes: the toy tree (a 3x3 conv, a batch norm, two linears); the CLI at
truncate 5, S 4, b4 on the ``tiny_imagefolder`` fixture, 2 folds x 2
epochs."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import from_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz
from heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention import main
from heuristique_style_transfer_code_tpu_torch.train import kfold as pk
from heuristique_style_transfer_code_tpu_torch.train import optim as po
from heuristique_style_transfer_code_tpu_torch.train import preemption

CFG = {"batch_size": 4, "lr": 0.05, "truncate_layer": 5, "gram_matrix_size": 4, "seed": 0}
DECAY = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps the test workers that share
    the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Toy(torch.nn.Module):
    def __init__(self):
        super().__init__()
        from heuristique_style_transfer_code_tpu_torch.nn.resnet import BatchNorm, Conv2d
        from heuristique_style_transfer_code_tpu_torch.ops.linear import Linear

        gen = torch.Generator().manual_seed(0)
        self.encoder = torch.nn.Module()
        self.encoder.conv1 = Conv2d(3, 4, 3, generator=gen)
        self.encoder.bn1 = BatchNorm(4)
        self.classifier = Linear(4, 3, generator=gen)
        self.attention = Linear(4, 4, generator=gen)


def _is_stat(key):
    return key.endswith(("/mean", "/var"))


@pytest.mark.parametrize("freeze", [False, True])
def test_ema_matches_jax_over_three_updates(freeze):
    from heuristique_style_transfer_code_tpu.train.optim import (
        extract_ema_variables as j_extract,
        find_ema_state as j_find,
        sgd_momentum as j_sgd,
    )

    toy = _Toy()
    tree = to_jax_tree(toy)
    frozen = (lambda path: path.startswith("encoder.conv1")) if freeze else None  # noqa: E731
    j_opt = j_sgd(0.1, tree, frozen_fn=frozen, ema_decay=DECAY)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = j_opt.init(j_params)
    init, update = po.sgd_momentum(0.1, frozen_fn=frozen, ema_decay=DECAY)
    state = init(toy)
    rng = np.random.RandomState(1)
    for _ in range(3):
        grads = jax.tree_util.tree_map(lambda a: rng.randn(*np.shape(a)).astype(np.float32), tree)
        upd, j_state = j_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, upd)
        update(toy, from_jax_tree(grads), state)
    assert j_find(j_state) is not None and po.find_ema_state(state) is state["ema"]
    # a forward would move the running statistics: both sides take these live
    stats = {"mean": rng.randn(4).astype(np.float32), "var": rng.rand(4).astype(np.float32) + .5}
    toy.encoder.bn1.running_mean.copy_(torch.from_numpy(stats["mean"]))
    toy.encoder.bn1.running_var.copy_(torch.from_numpy(stats["var"]))
    j_params["encoder"]["bn1"].update({k: jnp.asarray(v) for k, v in stats.items()})
    ev = po.extract_ema_variables(toy, state)
    assert ev is not toy
    got = _flatten(to_jax_tree(ev))
    want = _flatten(jax.tree_util.tree_map(np.asarray, j_extract(j_params, j_state)))
    live, start = _flatten(to_jax_tree(toy)), _flatten(tree)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-8, err_msg=key)
        if _is_stat(key):
            assert np.array_equal(got[key], live[key]), key
        elif freeze and key.startswith("encoder/conv1"):
            assert np.array_equal(got[key], start[key]), key
        else:  # the average lags the live weights
            assert not np.array_equal(got[key], live[key]), key
    frozen_names = {"encoder.conv1.weight"} if freeze else set()
    assert set(state["ema"]) == set(state["trace"]) == {
        n for n, _ in toy.named_parameters()} - frozen_names


@pytest.mark.parametrize("decay", [0.0, 1.0, 1.5, -0.1])
def test_decay_outside_the_open_unit_interval_raises(decay):
    from heuristique_style_transfer_code_tpu.train.optim import param_ema

    with pytest.raises(ValueError) as want:
        param_ema(decay)
    with pytest.raises(ValueError) as got:
        po.sgd_momentum(0.1, ema_decay=decay)
    assert str(got.value) == str(want.value)


def test_without_the_flag_the_state_has_no_ema():
    toy = _Toy()
    state = po.sgd_momentum(0.1)[0](toy)
    assert "ema" not in state and po.find_ema_state(state) is None
    assert po.extract_ema_variables(toy, state) is toy


@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("ema") / "cfg.json"
    with open(path, "w") as f:
        json.dump(CFG, f)
    return str(path)


def _args(folder, cfg, save_dir, *extra):
    return ["--data", str(folder), "--config_path", cfg, "--k_folds", "2", "--epochs", "2",
            "--save_dir", str(save_dir), "--device", "cpu", "--ema_decay", str(DECAY), *extra]


@pytest.fixture(scope="module")
def ema_run(tiny_imagefolder, cfg_path, tmp_path_factory):
    """The CLI with --ema_decay, uninterrupted, recording the tree of each
    evaluation model ``extract_ema_variables`` gives: (its directory,
    those trees)."""
    out = tmp_path_factory.mktemp("ema_run")
    trees = []
    real = po.extract_ema_variables

    def recording(model, opt_state):
        ev = real(model, opt_state)
        trees.append(_flatten(to_jax_tree(ev)))
        return ev

    po.extract_ema_variables = recording
    try:
        main(_args(tiny_imagefolder, cfg_path, out))
    finally:
        po.extract_ema_variables = real
    return out, trees


def test_fold_artifacts_are_the_ema_tree(ema_run):
    out, trees = ema_run
    assert len(trees) == 2  # one evaluation model a fold, without --early_stop
    for fold, want in enumerate(trees):
        got = _flatten(load_pytree_npz(str(out / f"best_model_fold_{fold}.npz")))
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want), fold


def test_resume_carries_the_ema_bit_identically(tiny_imagefolder, cfg_path, ema_run, tmp_path,
                                               monkeypatch):
    calls = {"n": 0}

    def fake():
        calls["n"] += 1
        return calls["n"] > 4

    monkeypatch.setattr(preemption, "preemption_requested", fake)
    main(_args(tiny_imagefolder, cfg_path, tmp_path, "--resume"))
    monkeypatch.undo()
    st = load_pytree_npz(str(tmp_path / pk._INPROGRESS_STATE))
    assert int(st["epochs_done"]) == 1
    ema, trace = _flatten(st["opt"]["ema"]), _flatten(st["opt"]["trace"])
    variables = _flatten(st["variables"])
    assert ema.keys() == trace.keys() and set(ema) <= set(variables)
    assert any(not np.array_equal(ema[k], variables[k]) for k in ema)
    main(_args(tiny_imagefolder, cfg_path, tmp_path, "--resume"))
    uninterrupted = ema_run[0]
    for name in ("best_global_model.npz", "best_model_fold_0.npz", "best_model_fold_1.npz"):
        a = _flatten(load_pytree_npz(str(uninterrupted / name)))
        b = _flatten(load_pytree_npz(str(tmp_path / name)))
        assert a.keys() == b.keys()
        assert all(np.array_equal(a[k], b[k]) for k in a), name
