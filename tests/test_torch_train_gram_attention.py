"""Family-2 training in the port against the JAX package, on the CPU:
train-mode batch norm, SGD with momentum (mask, schedule, clipping), the
masked cross-entropy, one train step of the model, the k-fold split, the
early stopper, the checkpoint loader's tensor count, and the CLI end to end
(the JAX CLI's artifact names and JSON keys, a resume after preemption
bit-identical to an uninterrupted run, the flags that raise "not ported
yet").

Tolerances, each against the JAX result on the same numpy inputs: batch
norm output 1e-5 of max|y| and running stats 1e-6 relative in f32 (only
the reduction order differs), 2e-2 in bf16 (one rounding of the output);
SGD 1e-6 relative over four updates; cross-entropy 1e-6; one train step in
f32: loss 1e-5 relative, each gradient leaf 1e-3 by relative L2 (measured
1.5e-5: oneDNN's and XLA's convolutions sum in other orders) and the
running stats 1e-4 relative; in float64 (JAX under ``jax.enable_x64``) the
update of every trainable leaf by relative L2 1e-5 (the port's attention
takes its softmax in f32, about 1e-8 from JAX's float64 one).

Sizes: the step at truncate 5 and 6, 32-pixel crops, b4, S 4 and 7; the
CLI on the ``tiny_imagefolder`` fixture (24 train images, 224² crops as the
CLI takes) at truncate 5, S 4, b4, 2 folds. The port's folds start from a
``torch.Generator`` init, not JAX's, so the two CLIs' runs are compared by
their artifacts' names and keys, not by value."""
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
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz
from heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention import main
from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
    gram_attention_apply,
    gram_attention_init,
)
from heuristique_style_transfer_code_tpu_torch.ops.norm import batch_norm
from heuristique_style_transfer_code_tpu_torch.train import kfold as pk
from heuristique_style_transfer_code_tpu_torch.train import preemption
from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum
from heuristique_style_transfer_code_tpu_torch.train.train_loop import (
    make_train_step_body,
    masked_cross_entropy,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps the test workers that share
    the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------ batch norm


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batch_norm_matches_jax(dtype):
    from heuristique_style_transfer_code_tpu.ops.norm import batch_norm as j_bn

    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 4, 8) * 2 + 0.5).astype(np.float32)
    p = {"scale": rng.rand(8).astype(np.float32) + 0.5, "bias": rng.randn(8).astype(np.float32),
         "mean": rng.randn(8).astype(np.float32), "var": rng.rand(8).astype(np.float32) + 0.5}
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    want, new = j_bn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x, jdt), train=True)
    mean, var = torch.from_numpy(p["mean"].copy()), torch.from_numpy(p["var"].copy())
    got = batch_norm(torch.from_numpy(x).to(tdt), torch.from_numpy(p["scale"]),
                     torch.from_numpy(p["bias"]), mean, var, train=True)
    assert got.dtype == tdt and got.is_contiguous()
    assert mean.dtype == var.dtype == torch.float32  # the buffers stay f32 under bf16
    want = np.asarray(want, np.float32)
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol * np.abs(want).max())
    stat_tol = 1e-6 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(mean.numpy(), np.asarray(new["mean"]), rtol=stat_tol, atol=1e-7)
    np.testing.assert_allclose(var.numpy(), np.asarray(new["var"]), rtol=stat_tol)


def test_eval_batch_norm_leaves_the_buffers():
    mean, var = torch.zeros(4), torch.ones(4)
    x = torch.randn(2, 3, 3, 4)
    batch_norm(x, torch.ones(4), torch.zeros(4), mean, var)
    assert torch.equal(mean, torch.zeros(4)) and torch.equal(var, torch.ones(4))


# ------------------------------------------------------------------- SGD


class _Toy(torch.nn.Module):
    """Leaves of every kind the family-2 tree has: an encoder conv, a batch
    norm (scale, bias and running statistics), the classifier, the
    attention projection."""

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


@pytest.mark.parametrize("freeze", [False, True])
@pytest.mark.parametrize("schedule,clip", [(None, None), ("cosine", 0.5), ("linear", None)])
def test_sgd_momentum_matches_optax_over_four_updates(freeze, schedule, clip):
    from heuristique_style_transfer_code_tpu.train.optim import sgd_momentum as j_sgd
    from heuristique_style_transfer_code_tpu.train.schedules import make_lr_schedule as j_sched
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import from_jax_tree
    from heuristique_style_transfer_code_tpu_torch.train.schedules import make_lr_schedule

    toy = _Toy()
    tree = to_jax_tree(toy)
    j_frozen = p_frozen = None
    if freeze:
        j_frozen = lambda path: not path.startswith(("classifier", "attention"))  # noqa: E731
        p_frozen = j_frozen
    lr, j_lr = 0.1, 0.1
    if schedule is not None:
        lr = make_lr_schedule(schedule, 0.1, 4, 1, 0.1)
        j_lr = j_sched(schedule, 0.1, 4, 1, 0.1)
    j_opt = j_sgd(j_lr, tree, frozen_fn=j_frozen, clip_norm=clip)
    j_params = jax.tree_util.tree_map(jnp.asarray, tree)
    j_state = j_opt.init(j_params)
    init, update = sgd_momentum(lr, frozen_fn=p_frozen, clip_norm=clip)
    state = init(toy)
    rng = np.random.RandomState(1)
    for _ in range(4):
        grads = jax.tree_util.tree_map(lambda a: rng.randn(*np.shape(a)).astype(np.float32), tree)
        upd, j_state = j_opt.update(jax.tree_util.tree_map(jnp.asarray, grads), j_state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params, upd)
        update(toy, from_jax_tree(grads), state)
    assert state["count"] == 4
    got, want = _flatten(to_jax_tree(toy)), _flatten(jax.tree_util.tree_map(np.asarray, j_params))
    start = _flatten(tree)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, atol=1e-7, err_msg=key)
        moved = not np.array_equal(got[key], start[key])
        frozen = key.endswith(("/mean", "/var")) or (freeze and key.startswith("encoder"))
        assert moved != frozen, key


# ---------------------------------------------------------- cross-entropy


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_masked_cross_entropy_matches_jax(smoothing):
    from heuristique_style_transfer_code_tpu.train.train_loop import masked_cross_entropy as j_ce

    rng = np.random.RandomState(3)
    logits = rng.randn(6, 4).astype(np.float32) * 3
    labels = np.array([0, 3, -1, 2, -1, 1], np.int32)  # two pad entries
    want = float(j_ce(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(masked_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                     smoothing))
    assert got == pytest.approx(want, rel=1e-6)
    all_pads = masked_cross_entropy(torch.from_numpy(logits), torch.full((6,), -1))
    assert float(all_pads) == 0.0


# ------------------------------------------------------- one train step


def _jax_step(truncate, s, u8, labels, lr, f64):
    """JAX, jitted. f32: the loss, the gradients (``jax.value_and_grad`` of
    the step's loss) and the forward's new variables (its running
    statistics). float64: ``make_train_step_body``'s loss and updated
    variables."""
    from heuristique_style_transfer_code_tpu.data.augment import make_augment_fn as j_aug
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_init as j_init,
    )
    from heuristique_style_transfer_code_tpu.train.optim import sgd_momentum as j_sgd
    from heuristique_style_transfer_code_tpu.train.train_loop import (
        make_train_step_body as j_body,
    )
    from heuristique_style_transfer_code_tpu.train.train_loop import masked_cross_entropy as j_ce

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    with jax.enable_x64() if f64 else contextlib.nullcontext():
        dt = jnp.float64 if f64 else jnp.float32
        variables = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dt),
                                           j_init(jax.random.PRNGKey(0), truncate, 4, s))
        aug = j_aug([(None, None)], crop=32)

        def augment(images, combos, key):
            return aug(images, combos, key).astype(dt)

        def forward(v, images):
            _, logits, new_v = j_apply(v, images, truncate, s, 4, train=True)
            return logits, new_v

        combos, key = jnp.zeros(len(labels), jnp.int32), jax.random.PRNGKey(1)
        if not f64:
            images = augment(jnp.asarray(u8), combos, key)

            def loss_fn(v):
                logits, new_v = forward(v, images)
                return j_ce(logits, jnp.asarray(labels)), new_v

            (loss, new_v), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables)
            return float(loss), to_np(variables), to_np(grads), to_np(new_v)
        opt = j_sgd(lr, variables)
        new_v, _, loss = jax.jit(j_body(forward, opt, augment))(
            variables, opt.init(variables), jnp.asarray(u8), jnp.asarray(labels), combos, key)
        return float(loss), to_np(variables), None, to_np(new_v)


def _port_model(tree, truncate, s, dtype):
    model = gram_attention_init(None, truncate, 4, s, device="cpu")
    return load_jax_tree(model, tree).to(dtype).train()


def _port_grads(model, forward, images, labels):
    """The port's loss and gradients (JAX layout, flat keys) of one step."""
    loss = masked_cross_entropy(forward(model, images), torch.from_numpy(labels))
    named = list(model.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return float(loss), _flatten(to_jax_tree(model, {n: g for (n, _), g in zip(named, grads)}))


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


@pytest.mark.parametrize("truncate,s", [(5, 4), (6, 7)])
def test_train_step_matches_jax(truncate, s):
    """One family-2 train step from carried weights. In float64 (JAX under
    ``enable_x64``): the loss, every gradient leaf, the whole step's update
    of every trainable leaf (SGD included) and the running statistics. In
    f32: the loss, the running statistics and the head's gradients
    (classifier and attention). The encoder's f32 gradients are held in
    float64 only: at these sizes a stage's batch norm sees 64 values a
    channel, some channels are nearly constant, and the ReLU after the
    residual add then switches on rounding noise, so the port's own f32
    gradients at the stem move by a few percent between one and two CPU
    threads (measured 8e-6 and 2e-2 from float64)."""
    rng = np.random.RandomState(4)
    u8 = rng.randint(0, 256, (4, 40, 40, 3)).astype(np.uint8)
    labels = np.array([0, 3, -1, 2], np.int32)  # one pad entry
    lr = 0.05
    aug = make_augment_fn([(None, None)], crop=32)
    images = aug(torch.from_numpy(u8))
    truth = None
    for f64 in (True, False):
        dtype = torch.float64 if f64 else torch.float32

        def forward(model, x):
            model.train()
            return gram_attention_apply(model, x.to(dtype), truncate, s, 4)[1]

        j_loss, tree, j_grads, j_new = _jax_step(truncate, s, u8, labels, lr, f64)
        start_v, new_v = _flatten(tree), _flatten(j_new)
        loss, grads = _port_grads(_port_model(tree, truncate, s, dtype), forward, images, labels)
        assert loss == pytest.approx(j_loss, rel=1e-5 if not f64 else 1e-7)
        if f64:
            # JAX's gradients from its first SGD step (zero momentum): -update / lr
            truth = {k: -(new_v[k] - start_v[k]) / lr for k in grads}
            for key, g in grads.items():
                assert _rel_l2(g, truth[key]) <= 1e-5, key
            model = _port_model(tree, truncate, s, dtype)
            before = {n: p.detach().clone() for n, p in model.named_parameters()}
            init, update = sgd_momentum(lr)
            _, state, step_loss = make_train_step_body(forward, (init, update), aug)(
                model, init(model), u8, labels)
            assert state["count"] == 1 and float(step_loss) == pytest.approx(loss, rel=1e-12)
            moved = {n: p.detach() - before[n] for n, p in model.named_parameters()}
            for key, d in _flatten(to_jax_tree(model, moved)).items():
                assert _rel_l2(d, new_v[key] - start_v[key]) <= 1e-5, key
        else:
            j_grads = _flatten(j_grads)
            for key, g in grads.items():
                if key.startswith(("classifier", "attention")):
                    assert _rel_l2(g, truth[key]) <= 1e-4, key
                    assert _rel_l2(j_grads[key], truth[key]) <= 1e-4, key
            model = _port_model(tree, truncate, s, dtype)
            forward(model, images)
        stats = _flatten(to_jax_tree(model))
        for key, want in new_v.items():
            if key.endswith(("/mean", "/var")):
                np.testing.assert_allclose(stats[key], want, rtol=1e-4, atol=1e-6, err_msg=key)


def test_frozen_encoder_trains_only_the_head():
    """``--freeze_layers``: the encoder's parameters need no gradient and
    stay put, its running statistics still move, the head trains."""
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention

    cfg = GramAttentionConfig(batch_size=4, lr=0.1, truncate_layer=5, gram_matrix_size=4)
    setup = setup_gram_attention(cfg, 4, [(None, None)], freeze_encoder=True, device="cpu")
    model, state = setup.init(torch.Generator().manual_seed(0))
    assert all(not p.requires_grad for p in model.encoder.parameters())
    assert sorted({n.split(".")[0] for n in state["trace"]}) == ["attention", "classifier"]
    before = {k: v.clone() for k, v in model.state_dict().items()}

    def forward(m, images):
        m.train()
        return gram_attention_apply(m, images, 5, 4, 4)[1]

    step = make_train_step_body(forward, setup.optimizer, make_augment_fn([(None, None)], 32))
    u8 = np.random.RandomState(5).randint(0, 256, (4, 40, 40, 3)).astype(np.uint8)
    step(model, state, u8, np.array([0, 1, 2, 3], np.int32))
    for key, v in model.state_dict().items():
        moved = not torch.equal(v, before[key])
        if key.startswith("encoder"):
            assert moved == key.endswith(("running_mean", "running_var")), key
        else:
            assert moved, key


# ------------------------------------------------------- k-fold, stopper


@pytest.mark.parametrize("n,k,seed", [(24, 2, 0), (25, 3, 7), (10, 4, 42), (5, 5, 1)])
def test_kfold_split_matches_scikit_learn(n, k, seed):
    from sklearn.model_selection import KFold

    want = list(KFold(n_splits=k, shuffle=True, random_state=seed).split(np.arange(n)))
    got = pk.kfold_split(n, k, seed)
    assert len(got) == len(want)
    for (gt, gv), (wt, wv) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gv, wv)


def test_kfold_split_refuses_too_few_samples():
    with pytest.raises(ValueError):
        pk.kfold_split(3, 4, 0)


def test_early_stopper_matches_jax():
    from heuristique_style_transfer_code_tpu.train.early_stop import EarlyStopper as JStopper
    from heuristique_style_transfer_code_tpu_torch.train.early_stop import EarlyStopper

    losses = [1.0, 0.8, 0.9, 0.8, 0.7, 0.75, 0.76]
    ours, theirs = EarlyStopper(2), JStopper(2)
    for epoch, loss in enumerate(losses):
        tree = {"w": np.full(2, float(epoch))}
        assert ours.update(loss, tree, epoch) == theirs.update(loss, tree, epoch)
        assert ours.improved_last == theirs.improved_last
    assert ours.best_epoch == theirs.best_epoch == 4
    leaves = ours.state_leaves()
    again = EarlyStopper(2)
    again.restore(leaves, ours.best_variables)
    assert (again.best_loss, again.since, again.best_epoch) == (0.7, 2, 4)


# -------------------------------------------------------------------- CLI

CFG = {"batch_size": 4, "lr": 0.01, "truncate_layer": 5, "gram_matrix_size": 4, "seed": 0}


FOLD_MODEL = "best_model_fold_0.npz"
ONE_EPOCH = ("--epochs", "1")

@pytest.fixture(scope="module")
def cfg_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("f2train") / "cfg.json"
    with open(path, "w") as f:
        json.dump(CFG, f)
    return str(path)


def _args(folder, cfg, save_dir, *extra, epochs=2):
    return ["--data", str(folder), "--config_path", cfg, "--k_folds", "2", "--epochs",
            str(epochs), "--save_dir", str(save_dir), "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def jax_run(tiny_imagefolder, cfg_path, tmp_path_factory):
    """The JAX CLI once (1 epoch): its artifact directory."""
    from heuristique_style_transfer_code_tpu.cli.train_gram_attention import main as j_main

    out = tmp_path_factory.mktemp("jax_f2train")
    j_main(["--data", str(tiny_imagefolder), "--config_path", cfg_path, "--k_folds", "2",
            "--epochs", "1", "--save_dir", str(out)])
    return out


@pytest.fixture(scope="module")
def port_run(tiny_imagefolder, cfg_path, tmp_path_factory):
    """The port's CLI once, uninterrupted (2 epochs): its artifact directory."""
    out = tmp_path_factory.mktemp("port_f2train")
    main(_args(tiny_imagefolder, cfg_path, out))
    return out


def _keys(node):
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_keys(v) for v in node]
    return type(node).__name__


def test_cli_writes_the_jax_artifacts(jax_run, port_run):
    names = sorted(os.listdir(port_run))
    assert names == sorted(os.listdir(jax_run))
    for want in ("best_performance_fold_0.json", "best_hyperparameters_fold_1.json",
                 "best_global_model.npz", "best_global_model_hyperparameters.json",
                 "best_model_results.json", "training_info.json", "events.jsonl"):
        assert want in names
    for name in names:
        if name.endswith(".json"):
            with open(port_run / name) as f, open(jax_run / name) as g:
                ours, theirs = json.load(f), json.load(g)
            assert _keys(ours) == _keys(theirs), name
    with open(port_run / "best_hyperparameters_fold_0.json") as f:
        assert json.load(f)["model_path"] == str(port_run / "best_model_fold_0.npz")
    kinds = [json.loads(line)["kind"] for line in open(port_run / "events.jsonl")]
    assert kinds == ["fold_result", "fold_result", "average_results"]
    for name in names:
        if name.endswith(".npz"):
            assert _keys(load_pytree_npz(str(port_run / name))) == _keys(
                load_pytree_npz(str(jax_run / name))), name


def test_cli_checkpoint_classifies_in_both_packages(port_run):
    """best_global_model.npz in the JAX layout: the JAX package's eval
    forward and the port's give the same logits."""
    from heuristique_style_transfer_code_tpu.checkpoint.io import load_pytree_npz as j_load
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention import (
        load_gram_attention,
    )

    path = str(port_run / "best_global_model.npz")
    x = np.random.RandomState(6).randn(2, 64, 64, 3).astype(np.float32)
    _, want, _ = j_apply(j_load(path), jnp.asarray(x), 5, 4, 4, train=False)
    model = load_gram_attention(path, 5, None, 4, torch.device("cpu"))
    with torch.no_grad():
        _, got = gram_attention_apply(model, torch.from_numpy(x), 5, 4, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _preempt_after(monkeypatch, n):
    calls = {"n": 0}

    def fake():
        calls["n"] += 1
        return calls["n"] > n

    monkeypatch.setattr(preemption, "preemption_requested", fake)


@pytest.mark.parametrize("checks,extra", [(4, ()), (8, ("--async_checkpoint",))])
def test_resume_after_preemption_is_bit_identical(tiny_imagefolder, cfg_path, port_run,
                                                  tmp_path, monkeypatch, capsys, checks,
                                                  extra):
    """Preempted before the 5th step (fold 0, epoch 2: one epoch on disk)
    or the 9th (fold 1, epoch 1: fold 0 done, nothing of fold 1 on disk),
    then the same command: every artifact equals the uninterrupted run's."""
    args = _args(tiny_imagefolder, cfg_path, tmp_path, "--resume", *extra)
    _preempt_after(monkeypatch, checks)
    main(args)
    assert "Preempted: preempted: progress through epoch" in capsys.readouterr().out
    assert not (tmp_path / "best_model_results.json").exists()
    assert (tmp_path / pk._INPROGRESS_STATE).exists()
    assert (tmp_path / pk._INPROGRESS_META).exists() == (checks > 6)
    monkeypatch.undo()
    main(args)
    assert "Resuming from fold" in capsys.readouterr().out
    for name in (pk._INPROGRESS_STATE, pk._INPROGRESS_META):
        assert not (tmp_path / name).exists()
    for name in ("best_global_model.npz", "best_model_fold_0.npz", "best_model_fold_1.npz"):
        a = _flatten(load_pytree_npz(str(port_run / name)))
        b = _flatten(load_pytree_npz(str(tmp_path / name)))
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{name} {key}")
    for name in ("fold_0_performance.json", "fold_1_performance.json"):
        with open(port_run / name) as f, open(tmp_path / name) as g:
            assert json.load(f) == json.load(g)


@pytest.mark.parametrize("change", [
    ("--label_smoothing", "0.1"), ("--freeze_layers",), ("--ema_decay", "0.9"),
    ("--mixup", "0.2"), ("--cutmix", "1.0")])
def test_resume_under_another_configuration_is_refused(tiny_imagefolder, cfg_path, tmp_path,
                                                       monkeypatch, change):
    _preempt_after(monkeypatch, 3)
    main(_args(tiny_imagefolder, cfg_path, tmp_path, "--resume"))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="does not match"):
        main(_args(tiny_imagefolder, cfg_path, tmp_path, "--resume", *change))


def test_early_stop_keeps_the_best_epoch(tiny_imagefolder, cfg_path, tmp_path, capsys):
    """--early_stop: each fold validates every epoch, and its artifacts
    describe the best epoch's weights (the fold-end evaluation reproduces
    that epoch's validation loss)."""
    import re

    main(_args(tiny_imagefolder, cfg_path, tmp_path, "--early_stop", "1", epochs=3))
    out = capsys.readouterr().out
    restored = re.findall(r"Fold (\d): restored best-epoch weights \(epoch (\d), val loss "
                          r"([0-9.]+)\)", out)
    assert [int(f) for f, _, _ in restored] == [0, 1]
    for fold, _, loss in restored:
        with open(tmp_path / f"fold_{fold}_performance.json") as f:
            assert f"{json.load(f)['val_loss']:.4f}" == loss


def test_pretrained_tensor_count_matches_jax(f1_checkpoint, tmp_path, capsys):
    """--model_path: the "tensors matched" count of a family-2 checkpoint
    (everything) and of a family-1 one (its encoder), as the JAX CLI
    counts them."""
    from heuristique_style_transfer_code_tpu.checkpoint.pth_converter import (
        shape_filtered_update as j_update,
    )
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_init as j_init,
    )
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
    from heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention import (
        _load_pretrained,
    )
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig

    cfg = GramAttentionConfig.from_dict(CFG)
    f2 = str(tmp_path / "f2.npz")
    save_pytree_npz(to_jax_tree(gram_attention_init(torch.Generator().manual_seed(1), 5, 4, 4,
                                                    device="cpu")), f2)
    for path, family1 in ((f2, False), (f1_checkpoint[1], True)):
        tree = _load_pretrained(path, cfg, 4, {})
        out = capsys.readouterr().out
        stats = {}
        j_update(j_init(jax.random.PRNGKey(0), 5, 4, 4), load_pytree_npz(path)
                 if not family1 else {"encoder": load_pytree_npz(path)["moco"]["encoder"]},
                 stats)
        assert f"({stats['loaded']}/{stats['total']} tensors matched)" in out
        assert ("Family-1 checkpoint detected" in out) == family1
        assert set(tree) == ({"encoder"} if family1 else {"encoder", "classifier", "attention"})


@pytest.mark.parametrize("extra", [
    ("--zero1",), ("--parallel_folds",), ("--devices", "2"), ("--checkpoint_format", "orbax")])
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
    args = _args(tiny_imagefolder, cfg_path, tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(args[:-2])


@pytest.mark.parametrize("extra", FLAG_CASES)
def test_ema_mixing_and_auto_batch_flags_run(tiny_imagefolder, cfg_path, tmp_path,
                                             one_epoch_run, extra, capsys):
    """``--ema_decay``, ``--mixup``, ``--cutmix``, ``--auto_batch`` with
    ``--hbm_budget_gb`` and ``--hbm_budget_gb`` alone through the CLI,
    against its plain run (``tests/torch_train_flags.py`` says what each
    case holds; the numbers are held against JAX in
    ``test_torch_ema.py``, ``test_torch_mixing.py`` and
    ``test_torch_autotune.py``)."""
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention

    def args_fn(save_dir, *extra, config=cfg_path):
        return _args(tiny_imagefolder, config, save_dir, *ONE_EPOCH, *extra)

    def make_setup(cfg):
        return setup_gram_attention(GramAttentionConfig.from_dict(cfg), 4, [(None, None)],
                                    device="cpu")

    check_flag_run(main, args_fn, tmp_path / "out", one_epoch_run, extra, CFG,
                   FOLD_MODEL, make_setup, capsys, tmp_path)
