"""``--remat`` and truncate 10 in the port against the JAX package, on the
CPU, and ``--debug_nans``'s checks.

Remat: one step of each family's ``setup_*().train_step(remat=True)``
against the JAX setup's remat step from the same init (family 1 at
truncate 5, family 3 under norm "batch" and "instance"); family 2's train
forward's gradients and running statistics in float64 against JAX's
remat forward; and the port's remat step against its own plain step,
which must agree bit for bit on the CPU in every parameter and every
running statistic (the recompute runs the same ops and updates no running
statistic a second time). The family-2 style loop's pixel gradient through
``make_gram_fn_gram_attention(remat=True)`` against JAX's in float64, and
in f32 bit for bit against the port's without remat.

Tolerances, as the plain steps' tests (``test_torch_train_*.py``): the
loss 1e-5 relative; each leaf's move by relative L2 1e-4 on the heads and
1e-2 on the encoders and discriminators (oneDNN's and XLA's convolutions
sum in other orders, and train-mode batch norms amplify it toward the
first stages), the gap less two f32 spacings of the leaf's values (a
batch-norm scale near 1 that moves by 1e-6 is resolved to 6e-8 in f32 in
either package); running statistics 1e-4 relative; the conv biases that a
norm follows (true gradient 0) move under 1e-6 in both packages. The
style loop's float64 gradient 1e-6 by relative L2. Truncate 10's logits
1e-5 of their largest magnitude.

Sizes: b2 224² crops of 224² staged uint8 (the setups' crop), ndf 8 with
patch sizes 10/20/40; family 2 at truncate 5, S 4, b4, 32² crops (float64:
gradients 1e-5 by relative L2, loss 1e-7, running statistics 1e-7); the
style loop at truncate 6, b2, 32² canvases; truncate 10 on 32² inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten
from heuristique_style_transfer_code_tpu_torch.config import schema
from heuristique_style_transfer_code_tpu_torch.train import factories

F3_PATCHES = {"small": 10, "medium": 20, "large": 40}
CASES = {
    "family1": ("TruncatedResNetConfig", "setup_truncated_resnet50",
                dict(batch_size=2, lr=0.05, truncate_layer=5, dim=16)),
    "family3-batch": ("MultiPatchGANConfig", "setup_multi_patchgan",
                      dict(batch_size=2, lr=0.05, ndf=8, patch_sizes=F3_PATCHES, norm="batch")),
    "family3-instance": ("MultiPatchGANConfig", "setup_multi_patchgan",
                         dict(batch_size=2, lr=0.05, ndf=8, patch_sizes=F3_PATCHES,
                              norm="instance")),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b) / np.linalg.norm(b))


def _move_gap(got, want, start):
    """The gap between two updated leaves relative to the move the step
    made, less two f32 spacings of each value: a move of 1e-6 on a leaf
    near 1 is resolved to about 6e-8 only, whichever package made it."""
    floor = 2 * np.linalg.norm(np.spacing(np.abs(start).astype(np.float32)))
    gap = np.linalg.norm(np.asarray(got, np.float64) - want)
    return max(0.0, gap - floor) / np.linalg.norm(np.asarray(want, np.float64) - start)


def _port_step(case, tree, u8, labels, remat):
    """One port train step from ``tree``: (loss, the model's leaves after
    it, flat JAX layout)."""
    cfg_name, setup_name, kw = CASES[case]
    setup = getattr(factories, setup_name)(getattr(schema, cfg_name)(**kw), 4, [(None, None)],
                                           remat=remat, device="cpu")
    model, state = setup.init(None)
    load_jax_tree(model, tree)
    _, state, loss = setup.train_step(model, state, u8, labels)
    assert state["count"] == 1
    return float(loss), _flatten(to_jax_tree(model))


@pytest.mark.parametrize("case", list(CASES))
def test_remat_step_matches_jax_and_the_plain_step(case):
    from heuristique_style_transfer_code_tpu.config import schema as j_schema
    from heuristique_style_transfer_code_tpu.train import factories as j_factories

    cfg_name, setup_name, kw = CASES[case]
    b = kw["batch_size"]
    rng = np.random.RandomState(11)
    u8 = rng.randint(0, 256, (b, 224, 224, 3)).astype(np.uint8)
    labels = np.array([2, 0, -1, 3][:b], np.int32)
    # the port's seeded init, which the JAX setup takes as its pretrained
    # tree (family 1 copies it whole, quicker than JAX's eager ResNet init)
    setup = getattr(factories, setup_name)(getattr(schema, cfg_name)(**kw), 4, [(None, None)],
                                           device="cpu")
    tree = to_jax_tree(setup.init(torch.Generator().manual_seed(3))[0])
    js = getattr(j_factories, setup_name)(getattr(j_schema, cfg_name)(**kw), 4, [(None, None)],
                                          pretrained=tree, remat=True)
    variables, opt = js.init(jax.random.PRNGKey(3))
    start = _flatten(tree)
    new_v, _, j_loss = js.train_step(variables, opt, jnp.asarray(u8), jnp.asarray(labels),
                                     jnp.zeros(b, jnp.int32), jax.random.PRNGKey(4))
    want = _flatten(jax.tree_util.tree_map(np.asarray, new_v))

    loss, got = _port_step(case, tree, u8, labels, remat=True)
    plain_loss, plain = _port_step(case, tree, u8, labels, remat=False)
    assert loss == plain_loss
    assert got.keys() == plain.keys() == want.keys()
    for key in want:
        if key.endswith("__none__"):
            continue
        assert np.array_equal(got[key], plain[key]), key  # bit for bit, stats included
        if key.endswith(("/mean", "/var")):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6, err_msg=key)
        elif case.startswith("family3") and key.endswith("conv/bias") and "out_conv" not in key:
            assert np.abs(got[key] - start[key]).max() <= 1e-6, key
            assert np.abs(want[key] - start[key]).max() <= 1e-6, key
        else:
            head = key.startswith(("classifier", "attention", "moco/fc"))
            tol = 1e-4 if head else 1e-2
            assert _move_gap(got[key], want[key], start[key]) <= tol, key
    assert loss == pytest.approx(float(j_loss), rel=1e-5)
    if case in ("family1", "family2", "family3-batch"):
        moved = [k for k in want if k.endswith("/mean") and not np.array_equal(got[k], start[k])]
        assert moved  # the statistics did update, once


def test_remat_family2_gradients_match_jax_in_float64():
    """Family 2 through its train forward with remat: in float64 (JAX under
    ``enable_x64``) the loss, every gradient leaf and the running
    statistics against JAX's remat forward (its Gram head makes the stem's
    f32 gradients chaotic at these sizes, as ``test_torch_train_gram_attention``
    notes, so f32 is held against the port's own plain step, bit for
    bit)."""
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_apply as j_apply,
    )
    from heuristique_style_transfer_code_tpu.train.train_loop import masked_cross_entropy as j_ce
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import masked_cross_entropy

    rng = np.random.RandomState(12)
    u8 = rng.randint(0, 256, (4, 40, 40, 3)).astype(np.uint8)
    labels = np.array([0, 3, -1, 2], np.int32)
    images = make_augment_fn([(None, None)], crop=32)(torch.from_numpy(u8))
    tree = to_jax_tree(gram_attention_init(torch.Generator().manual_seed(13), 5, 4, 4,
                                           device="cpu"))

    def port(dtype, remat):
        model = load_jax_tree(gram_attention_init(None, 5, 4, 4, device="cpu"), tree)
        model = model.to(dtype).train()
        _, logits = gram_attention_apply(model, images.to(dtype), 5, 4, 4, remat=remat)
        loss = masked_cross_entropy(logits, torch.from_numpy(labels))
        named = list(model.named_parameters())
        grads = torch.autograd.grad(loss, [p for _, p in named])
        moved = {n: g for (n, _), g in zip(named, grads)}
        return float(loss), _flatten(to_jax_tree(model, moved)), _flatten(to_jax_tree(model))

    with jax.enable_x64():
        v = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)

        def loss_fn(v):
            _, logits, new_v = j_apply(v, jnp.asarray(images.double().numpy()), 5, 4, 4,
                                       train=True, remat=True)
            return j_ce(logits, jnp.asarray(labels)), new_v

        (j_loss, j_new), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(v)
        j_grads = _flatten(jax.tree_util.tree_map(np.asarray, j_grads))
        j_new = _flatten(jax.tree_util.tree_map(np.asarray, j_new))
    loss, grads, stats = port(torch.float64, True)
    assert loss == pytest.approx(float(j_loss), rel=1e-7)
    for key, g in grads.items():
        assert _rel_l2(g, j_grads[key]) <= 1e-5, key
    for key, want in j_new.items():
        if key.endswith(("/mean", "/var")):
            np.testing.assert_allclose(stats[key], want, rtol=1e-7, atol=1e-9, err_msg=key)
    remat, plain = port(torch.float32, True), port(torch.float32, False)
    assert remat[0] == plain[0]
    for got, want in ((remat[1], plain[1]), (remat[2], plain[2])):
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_remat_style_loop_gradient_matches_jax():
    """The family-2 texture loop's pixel gradient through remat'd
    bottlenecks (eval-mode encoder, K1 outside the blocks): in float64
    against JAX's remat Gram program, and in f32 bit for bit the port's
    without remat."""
    from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
        make_gram_fn_gram_attention as j_make,
    )
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.tasks.style_transfer import (
        make_gram_fn_gram_attention,
    )

    tree = to_jax_tree(gram_attention_init(torch.Generator().manual_seed(5), 6, 4, 4,
                                           device="cpu"))
    rng = np.random.RandomState(6)
    x = rng.randn(2, 32, 32, 3)
    target = rng.rand(2, 512, 512) * 1e-2

    def port(dtype, remat):
        model = load_jax_tree(gram_attention_init(None, 6, 4, 4, device="cpu"), tree).to(dtype)
        gram_fn = make_gram_fn_gram_attention(model, 6, remat=remat)
        px = torch.from_numpy(x).to(dtype).requires_grad_(True)
        loss = torch.mean((gram_fn(px)[0] - torch.from_numpy(target).to(dtype)) ** 2)
        return torch.autograd.grad(loss, px)[0].numpy()

    with jax.enable_x64():
        j_gram = j_make(jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree), 6,
                        remat=True)
        j_grad = np.asarray(jax.jit(jax.grad(lambda p: jnp.mean((j_gram(p)[0] - target) ** 2)))(
            jnp.asarray(x)))
    assert _rel_l2(port(torch.float64, True), j_grad) <= 1e-6
    assert np.array_equal(port(torch.float32, True), port(torch.float32, False))


def test_truncate_10_runs_the_fc_child_as_jax():
    """The whole ResNet50 (truncate 10: the avgpool, then the fc child)
    from a JAX ``resnet50_init`` tree, through the weight bridge both
    ways."""
    from heuristique_style_transfer_code_tpu.nn.resnet import resnet50_apply as j_apply
    from heuristique_style_transfer_code_tpu.nn.resnet import resnet50_init
    from heuristique_style_transfer_code_tpu_torch.nn.resnet import (
        ResNet50Encoder,
        resnet50_apply,
    )

    # JAX's tree structure, the port's seeded values (JAX's eager init of
    # the whole network is slow)
    tree = to_jax_tree(ResNet50Encoder(10, torch.Generator().manual_seed(7), device="cpu",
                                       num_classes=10))
    j_shapes = jax.eval_shape(lambda: resnet50_init(jax.random.PRNGKey(7), 10))
    assert jax.tree_util.tree_map(lambda a: a.shape, j_shapes) == jax.tree_util.tree_map(
        np.shape, tree)
    x = np.random.RandomState(8).randn(2, 32, 32, 3).astype(np.float32)
    want = jax.jit(lambda t, v: j_apply(t, v, truncate=10)[0])(tree, jnp.asarray(x))
    enc = load_jax_tree(ResNet50Encoder(10, num_classes=10, device="cpu").eval(), tree)
    assert _flatten(to_jax_tree(enc)).keys() == _flatten(tree).keys()
    with torch.inference_mode():
        got, grams = resnet50_apply(enc, torch.from_numpy(x), truncate=10)
    want = np.asarray(want)
    assert got.shape == want.shape == (2, 10) and grams == []
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------ --debug_nans


def test_debug_nans_raises_in_the_forward_and_the_backward():
    """A NaN that a module returns stops the forward; one that only a
    backward function produces (the square root's gradient at 0, times 0)
    stops the backward; both as ``FloatingPointError``; off, neither is
    checked. The loops' ``check_nan`` reads nothing unless it is on."""
    from heuristique_style_transfer_code_tpu_torch.utils.debug import check_nan, debug_nans

    lin = torch.nn.Linear(3, 2)
    with torch.no_grad():
        lin.weight[0, 0] = float("nan")
    x = torch.ones(1, 3)
    lin(x)  # off: nothing checked
    with pytest.raises(FloatingPointError, match="invalid value \\(nan\\) encountered in Linear"):
        with debug_nans(True):
            lin(x)
    z = torch.zeros(2, requires_grad=True)
    with pytest.raises(FloatingPointError, match="returned nan values"):
        with debug_nans(True):
            (torch.sqrt(z) * 0.0).sum().backward()
    check_nan("a loss", float("nan"))  # off: no error
    with pytest.raises(FloatingPointError, match="a loss"):
        with debug_nans(True):
            check_nan("a loss", float("nan"))
    assert not torch.is_anomaly_enabled()
