"""The port's training utilities against the JAX package: ``HostLoader``'s
shuffled order, ``set_epoch``, ``set_position`` and tail padding
(``data/loader.py``), ``train/schedules.make_lr_schedule``,
``train/preemption.py``, ``checkpoint/async_io.AsyncCheckpointWriter`` and
the fast-style net's optimiser (``tasks/fast_style._make_optimizer``: Adam
with optional global-norm clipping and a schedule) against ``optax`` on the
same given gradients.

Tolerances: the loader's batches (images, labels, indices, counts) equal;
every schedule at every step within 1e-7 of optax's (optax evaluates in
float32, the port in float64); the optimiser's parameters within 1e-7 of
optax's, absolute plus relative, after each of four updates: the same
float32 formulas, other roundings of the sums, so a parameter near 1 may
land one float32 step (1.19e-7) away."""
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from heuristique_style_transfer_code_tpu.data.loader import HostLoader as JHostLoader
from heuristique_style_transfer_code_tpu.train import preemption as jpre
from heuristique_style_transfer_code_tpu.train.schedules import make_lr_schedule as j_schedule
from heuristique_style_transfer_code_tpu_torch.checkpoint.async_io import AsyncCheckpointWriter
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    from_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import save_pytree_npz
from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader
from heuristique_style_transfer_code_tpu_torch.nn.transformer_net import transformer_net_init
from heuristique_style_transfer_code_tpu_torch.tasks.fast_style import _make_optimizer
from heuristique_style_transfer_code_tpu_torch.train import preemption
from heuristique_style_transfer_code_tpu_torch.train.schedules import make_lr_schedule


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast alone and keeps the
    test workers that share the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batches(loader):
    return [(b["image"], b["label"], b["indices"], b["n_valid"]) for b in loader]


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g[:3], w[:3]):
            np.testing.assert_array_equal(a, b)
        assert g[3] == w[3]


@pytest.fixture(scope="module")
def samples(tiny_imagefolder):
    return ImageFolderIndex(str(tiny_imagefolder / "train")).samples[:11]


def test_loader_shuffled_epochs_and_padding_equal_jax(samples):
    """Three epochs of a fresh loader each (11 samples, batch 4: the last
    batch padded by cycling the epoch order), in order and after
    ``set_epoch``."""
    port = HostLoader(samples, 4, shuffle=True, seed=3, num_workers=2)
    jax_loader = JHostLoader(samples, 4, shuffle=True, seed=3, num_workers=2)
    epochs = []
    for _ in range(3):
        got, want = _batches(port), _batches(jax_loader)
        _assert_same_batches(got, want)
        assert got[-1][3] == 3 and (got[-1][1][3:] == -1).all()
        epochs.append(np.concatenate([b[2] for b in got]))
    assert not np.array_equal(epochs[0], epochs[1])  # each epoch its own order
    port.set_epoch(1)
    jax_loader.set_epoch(1)
    _assert_same_batches(_batches(port), _batches(jax_loader))
    assert len(port) == len(jax_loader) == 3


def test_loader_set_position_skips_without_decoding(samples, monkeypatch):
    from heuristique_style_transfer_code_tpu_torch.data import loader as loader_mod

    port = HostLoader(samples, 4, shuffle=True, seed=5, num_workers=2)
    jax_loader = JHostLoader(samples, 4, shuffle=True, seed=5, num_workers=2)
    port.set_position(2, 1)
    jax_loader.set_position(2, 1)
    decoded = []
    real = loader_mod.load_image_staged
    monkeypatch.setattr(loader_mod, "load_image_staged",
                        lambda path: decoded.append(path) or real(path))
    got = _batches(port)
    _assert_same_batches(got, _batches(jax_loader))
    assert len(got) == 2 and len(decoded) == 8  # the skipped batch was not decoded
    fresh = HostLoader(samples, 4, shuffle=True, seed=5, num_workers=2)
    fresh.set_epoch(2)
    _assert_same_batches(got, _batches(fresh)[1:])
    # once only: the next epoch starts at batch 0 again
    _assert_same_batches(_batches(port), _batches(jax_loader))


def test_loader_unshuffled_order_unchanged(samples):
    got = _batches(HostLoader(samples, 4, num_workers=2))
    _assert_same_batches(got, _batches(JHostLoader(samples, 4, num_workers=2)))
    np.testing.assert_array_equal(np.concatenate([b[2] for b in got])[:11], np.arange(11))


@pytest.mark.parametrize("name", ["constant", "cosine", "linear"])
@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("floor", [0.0, 0.1])
def test_schedule_matches_optax_at_every_step(name, warmup, floor):
    got = make_lr_schedule(name, 2e-3, 20, warmup, floor)
    want = j_schedule(name, 2e-3, 20, warmup, floor)
    if name == "constant" and warmup == 0:
        assert got is None and want is None
        return
    steps = np.arange(26)
    w = np.array([float(want(jnp.int32(s))) for s in steps])
    g = np.array([got(int(s)) for s in steps])
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-7)
    if warmup:
        assert g[0] == 0.0  # the first update moves nothing


def test_schedule_argument_errors_match_jax():
    for args in (("step", 1e-3, 10), ("linear", 1e-3, 0), ("linear", 1e-3, 10, -1),
                 ("cosine", 1e-3, 10, 0, 1.5)):
        with pytest.raises(ValueError) as want:
            j_schedule(*args)
        with pytest.raises(ValueError) as got:
            make_lr_schedule(*args)
        assert str(got.value) == str(want.value)


def test_preemption_flag_handler_and_message():
    preemption.clear_preemption()
    assert not preemption.preemption_requested()
    previous = signal.getsignal(signal.SIGTERM)
    try:
        assert preemption.install_sigterm_handler()
        os.kill(os.getpid(), signal.SIGTERM)
        assert preemption.preemption_requested()
    finally:
        signal.signal(signal.SIGTERM, previous)
        preemption.clear_preemption()
    assert not preemption.preemption_requested()
    preemption.request_preemption()
    assert preemption.preemption_requested()
    preemption.clear_preemption()
    assert str(preemption.PreemptedError(1, 2)) == str(jpre.PreemptedError(1, 2))
    err = preemption.PreemptedError(0, 1, message="m")
    assert (err.fold, err.epochs_done, str(err)) == (0, 1, "m")


def test_async_writer_snapshots_at_submit(tmp_path):
    """A tensor updated in place after ``submit`` leaves the file as it was
    at submit; the file reads back like ``save_pytree_npz``'s."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    arr = np.ones(4, np.float32)
    tree = {"t": t, "a": arr, "n": 3, "s": np.asarray("sig"), "l": [t[0]]}
    path = str(tmp_path / "ck.npz")
    with AsyncCheckpointWriter(max_pending=1) as w:
        w.submit(tree, path)
        t.add_(100.0)
        arr += 5
    sync = str(tmp_path / "sync.npz")
    save_pytree_npz({"t": np.arange(6, dtype=np.float32).reshape(2, 3),
                     "a": np.ones(4, np.float32), "n": 3, "s": np.asarray("sig"),
                     "l": [np.arange(3, dtype=np.float32)]}, sync)
    with np.load(path) as got, np.load(sync) as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k])


def test_async_writer_reraises_and_refuses_after_close(tmp_path):
    def failing(tree, path):
        raise OSError("disk full")

    w = AsyncCheckpointWriter(save_fn=failing)
    w.submit({"x": np.zeros(1)}, str(tmp_path / "x.npz"))
    with pytest.raises(OSError, match="disk full"):
        w.wait()
    w.close()
    w.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        w.submit({}, str(tmp_path / "y.npz"))


def _grads(tree, seed):
    """Seeded gradients in the JAX layout, one scale per leaf so that the
    clipping triggers on some updates and not on others."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: (rng.randn(*a.shape) * rng.choice([1e-4, 1e-2, 1.0])).astype(np.float32),
        tree)


@pytest.mark.parametrize("clip", [None, 0.5, 1e3])
@pytest.mark.parametrize("scheduled", [False, True])
def test_adam_matches_optax(clip, scheduled):
    """Four updates of the port's optimiser against ``optax.adam`` (chained
    after ``optax.clip_by_global_norm``) on the same gradients, from the
    same weights; with a schedule (cosine after a 2-step warmup) the first
    update has rate 0."""
    net = transformer_net_init(torch.Generator().manual_seed(0), width=4, n_res=1,
                               device="cpu")
    tree = to_jax_tree(net)
    lr = j_schedule("cosine", 1e-2, 6, 2, 0.1) if scheduled else 1e-2
    port_lr = make_lr_schedule("cosine", 1e-2, 6, 2, 0.1) if scheduled else 1e-2
    tx = optax.adam(lr)
    if clip is not None:
        tx = optax.chain(optax.clip_by_global_norm(clip), tx)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(params)
    init, update = _make_optimizer(port_lr, clip)
    opt = init(net)
    names = [n for n, _ in net.named_parameters()]
    for i in range(4):
        g = _grads(tree, i)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), state)
        params = optax.apply_updates(params, updates)
        sd = from_jax_tree(g)
        update(net, [sd[n] for n in names], opt)
        want = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, params))
        got = jax.tree_util.tree_leaves(to_jax_tree(net))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=1e-7, atol=1e-7)
        if scheduled and i == 0:
            for a, b in zip(got, jax.tree_util.tree_leaves(tree)):
                np.testing.assert_array_equal(a, b)
    assert opt["count"] == 4
