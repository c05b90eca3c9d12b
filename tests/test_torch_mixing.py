"""``--mixup`` and ``--cutmix``: the port's ``train/mixing.py`` and the
mixed train steps against the JAX package's ``train/mixing.py`` and
``make_train_step_body``/``make_train_step_accum``, on the CPU.

- Given the same lambda, shift and box centre (JAX's own draws replayed
  from its key), the mixed images agree within 1e-6 and the CutMix box
  and corrected lambda are JAX's exactly, degenerate lambdas included;
- the mixed loss of the plain step and of the ``--grad_accum 2`` step
  (mixup and cutmix, with label smoothing and a pad entry) matches JAX's
  steps on the same mixed batch within 1e-5 relative, and so does every
  updated leaf (relative L2 of its move 1e-5), all in float64;
- the draws depend on the batch's key alone, cover both modes under both
  flags and keep the roll in [1, max(B, 2)) and the centre in the image;
  turning mixing on leaves the loader's augmentation draws unchanged;
- ``train_epochs`` with mixing at ``--steps_per_dispatch 2`` gives the
  K = 1 run's losses and weights bit for bit.

Sizes: 4-6 images of 12-32 pixels; the steps on family 2 at truncate 5,
S 4, b4, 32² crops (float64: JAX under ``jax.enable_x64``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten
from heuristique_style_transfer_code_tpu_torch.train import mixing as pm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps the test workers that share
    the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_draws(key, b, h, w):
    """JAX ``make_mix_fn``'s shift and box centre for ``key``: its own
    splits replayed."""
    _, k_roll, k_box, _ = jax.random.split(key, 4)
    shift = int(jax.random.randint(k_roll, (), 1, max(b, 2)))
    ky, kx = jax.random.split(k_box)
    return shift, int(jax.random.randint(ky, (), 0, h)), int(jax.random.randint(kx, (), 0, w))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("lam", [0.0, 0.37, 0.81, 1.0])
def test_mixup_and_cutmix_match_jax(seed, lam):
    from heuristique_style_transfer_code_tpu.train import mixing as jm

    b, h, w = 5, 13, 17
    rng = np.random.RandomState(seed)
    images = rng.rand(b, h, w, 3).astype(np.float32)
    labels = np.array([0, 3, 1, -1, 2], np.int32)
    key = jax.random.PRNGKey(seed)
    shift, cy, cx = _jax_draws(key, b, h, w)
    j_partner, j_labels_b = jm._roll_partner(jnp.asarray(images), jnp.asarray(labels),
                                             jax.random.split(key, 4)[1])
    partner, labels_b = pm.roll_partner(torch.from_numpy(images), torch.from_numpy(labels),
                                        shift)
    assert np.array_equal(partner.numpy(), np.asarray(j_partner))
    assert np.array_equal(labels_b.numpy(), np.asarray(j_labels_b))
    want = jm._mixup_images(jnp.asarray(images), j_partner, jnp.float32(lam))
    got = pm.mixup_images(torch.from_numpy(images), partner, lam)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    j_box, j_lam = jm.cutmix_box(jax.random.split(key, 4)[2], h, w, jnp.float32(lam))
    box, lam_adj = pm.cutmix_box(cy, cx, h, w, lam)
    assert box == tuple(int(v) for v in j_box)
    assert np.float32(lam_adj) == np.float32(j_lam)
    want = jm._cutmix_images(jnp.asarray(images), j_partner, j_box)
    got = pm.cutmix_images(torch.from_numpy(images), partner, box)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_off_gives_no_mix_fn():
    assert pm.make_mix_fn() is None and pm.make_mix_fn(0.0, None) is None


def test_draws_depend_on_the_key_alone_and_cover_both_modes():
    seen = set()
    for i in range(64):
        key = (7, 1, 2, i)
        got = pm.mix_draws(key, 6, 32, 24, True, True, 0.2, 1.0)
        assert got == pm.mix_draws(key, 6, 32, 24, True, True, 0.2, 1.0)
        cut, lam, shift, cy, cx = got
        assert 0.0 <= lam <= 1.0 and 1 <= shift < 6 and 0 <= cy < 32 and 0 <= cx < 24
        seen.add(cut)
    assert seen == {True, False}
    assert pm.mix_draws((7, 1, 2, 0), 6, 32, 24, True, True, 0.2, 1.0) != pm.mix_draws(
        (7, 1, 3, 0), 6, 32, 24, True, True, 0.2, 1.0)
    assert pm.mix_draws((0, 0, 0, 0), 1, 8, 8, True, False, 0.2, None)[2] == 1  # b 1: roll 1
    assert not any(pm.mix_draws((0, 0, 0, i), 4, 8, 8, True, False, 0.2, None)[0]
                   for i in range(16))


def test_mixing_leaves_the_augmentation_draws_unchanged(tiny_imagefolder):
    from heuristique_style_transfer_code_tpu_torch.data.augment import batch_draws
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader

    samples = ImageFolderIndex(str(tiny_imagefolder / "train")).samples
    loader = HostLoader(samples, 8, shuffle=True, seed=3, draw_key=(3, 1))
    loader.set_epoch(2)
    for index, batch in enumerate(loader):
        assert batch["mix_key"] == (3, 1, 2, index)
        assert np.array_equal(batch["draws"], batch_draws((3, 1, 2, index), 8))


# ----------------------------------------------------------- the mixed steps


def _fixed_mix(side, mode, lam, shift, box):
    """A mix_fn of ``side`` ("jax" or "port") that applies the given
    lambda, roll and box with that package's functions."""
    if side == "jax":
        from heuristique_style_transfer_code_tpu.train import mixing as jm

        def mix(images, labels, key):
            partner, labels_b = jnp.roll(images, shift, 0), jnp.roll(labels, shift, 0)
            if mode == "cutmix":
                mixed = jm._cutmix_images(images, partner, tuple(jnp.int32(v) for v in box))
                return mixed, labels, labels_b, jnp.asarray(lam)
            return (jm._mixup_images(images, partner, jnp.asarray(lam)), labels, labels_b,
                    jnp.asarray(lam))
        return mix

    def mix(images, labels, key):
        partner, labels_b = pm.roll_partner(images, labels, shift)
        if mode == "cutmix":
            return pm.cutmix_images(images, partner, box), labels, labels_b, lam
        return pm.mixup_images(images, partner, lam), labels, labels_b, lam
    return mix


@pytest.mark.parametrize("mode", ["mixup", "cutmix"])
@pytest.mark.parametrize("accum", [False, True])
def test_mixed_steps_match_jax(mode, accum):
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu.train.optim import sgd_momentum as j_sgd
    from heuristique_style_transfer_code_tpu.train.train_loop import (
        make_train_step_accum as j_accum,
        make_train_step_body as j_body,
    )
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.optim import sgd_momentum
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import (
        make_train_step_accum,
        make_train_step_body,
    )

    rng = np.random.RandomState(20)
    u8 = rng.randint(0, 256, (4, 40, 40, 3)).astype(np.uint8)
    labels = np.array([0, 3, -1, 2], np.int32)
    lr, smoothing, shift = 0.05, 0.1, 3
    lam = 0.3 if mode == "mixup" else pm.cutmix_box(9, 20, 32, 32, 0.6)[1]
    box = pm.cutmix_box(9, 20, 32, 32, 0.6)[0]
    images = make_augment_fn([(None, None)], crop=32)(torch.from_numpy(u8)).double()
    tree = to_jax_tree(gram_attention_init(torch.Generator().manual_seed(21), 5, 4, 4,
                                           device="cpu"))
    start = _flatten(tree)

    model = load_jax_tree(gram_attention_init(None, 5, 4, 4, device="cpu"), tree)
    model = model.double().train()
    init, update = sgd_momentum(lr)

    def forward(m, x):
        return gram_attention_apply(m, x, 5, 4, 4)[1]

    args = (forward, (init, update), lambda x, c, d: images)
    mix = _fixed_mix("port", mode, lam, shift, box)
    step = (make_train_step_accum(*args, 2, smoothing, mix) if accum
            else make_train_step_body(*args, smoothing, mix))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    _, _, loss = step(model, init(model), u8, labels, mix_key=(0,))
    moves = _flatten(to_jax_tree(model, {n: p.detach() - before[n]
                                         for n, p in model.named_parameters()}))
    stats = _flatten(to_jax_tree(model))

    with jax.enable_x64():
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        x64 = jnp.asarray(images.numpy())

        def j_forward(v, x):
            _, logits, new_v = j_apply(v, x, 5, 4, 4, train=True)
            return logits, new_v

        opt = j_sgd(lr, v)
        j_mix = _fixed_mix("jax", mode, lam, shift, box)
        if accum:
            j_step = j_accum(j_forward, opt, lambda x, c, k: x64, 2, label_smoothing=smoothing,
                             mix_fn=j_mix)
        else:
            j_step = j_body(j_forward, opt, lambda x, c, k: x64, smoothing, mix_fn=j_mix)
        new_v, _, j_loss = jax.jit(j_step)(v, opt.init(v), jnp.asarray(u8), jnp.asarray(labels),
                                           jnp.zeros(4, jnp.int32), jax.random.PRNGKey(0))
        want = _flatten(jax.tree_util.tree_map(np.asarray, new_v))
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    for key in want:
        if key.endswith(("/mean", "/var")):
            np.testing.assert_allclose(stats[key], want[key], rtol=1e-6, atol=1e-8, err_msg=key)
            continue
        move, j_move = moves[key], want[key] - start[key]
        if np.linalg.norm(j_move) == 0:
            assert np.abs(move).max() <= 1e-12, key
            continue
        assert np.linalg.norm(move - j_move) <= 1e-5 * np.linalg.norm(j_move), key


def test_steps_per_dispatch_with_mixing_keeps_the_k1_run(tiny_imagefolder):
    from heuristique_style_transfer_code_tpu_torch.config.schema import MultiPatchGANConfig
    from heuristique_style_transfer_code_tpu_torch.data.imagefolder import ImageFolderIndex
    from heuristique_style_transfer_code_tpu_torch.data.loader import HostLoader
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_multi_patchgan
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import train_epochs

    cfg = MultiPatchGANConfig(batch_size=4, lr=0.05, ndf=8, norm="instance",
                              patch_sizes={"small": 10, "medium": 20, "large": 40})
    samples = ImageFolderIndex(str(tiny_imagefolder / "train")).samples[:12]
    setup = setup_multi_patchgan(cfg, 4, [(None, None)],
                                 mix_fn=pm.make_mix_fn(mixup_alpha=0.4, cutmix_alpha=1.0),
                                 device="cpu")
    runs = {}
    for k in (1, 2):
        model, opt = setup.init(torch.Generator().manual_seed(5))
        loader = HostLoader(samples, 4, shuffle=True, seed=1, draw_key=(1, 0))
        model, _ = train_epochs(setup.train_step, model, opt, loader, 1,
                                steps_per_dispatch=k)
        runs[k] = _flatten(to_jax_tree(model))
    assert all(np.array_equal(runs[1][key], runs[2][key]) for key in runs[1])
