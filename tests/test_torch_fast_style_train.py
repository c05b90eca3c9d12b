"""The port's fast-style training (``tasks/fast_style.py``: the train steps,
the style targets, the style draws, the training loop, the net's quality pricing)
against the JAX package, on the same seeded numpy inputs and the same
weights (JAX-initialised nets and encoders carried across with
``load_jax_tree``), and the net's instance norms through
``InstanceNormFunction``.

Size: the net at width 4, n_res 1 (the norm-routing test n_res 5), a
truncate-6 family-2 encoder (layer1 and layer2 Grams), crop 32 of 36²
batches of 2.

Tolerances (float32 on both sides): the first step's loss 1e-5 relative,
later steps' 1e-3; the gradients of a functional of the net's output 1e-4
of each leaf's own scale, and the training loss's gradients 1e-2 of each
leaf's norm (relative L2); the parameters after 1 and 3 Adam steps within
RMS 0.25 · steps · lr of JAX's, where steps · lr is Adam's largest move.
The last two are loose because the two packages' f32 stylised outputs
differ by about 1e-6, so a pre-ReLU activation of the encoder that lies
that close to zero falls on either side in the two packages and switches
a local part of the data gradient (seen here on one image of the
conditional step: 0.2% of the gradient's scale); Adam's normalised step
turns that into moves of up to 2 · lr apart on the entries whose
gradient is that small. The biases whose true gradient is zero are held
apart: each conv bias in front of an instance norm (conv1-3, every
residual conv, up1, up2) and each residual block's second norm bias (in_b:
no ReLU follows it, so its per-channel constant reaches only convs whose
norms remove it). Their f32 gradients are rounding noise (under 1e-5 of
the largest gradient), which Adam turns into steps of up to lr, so on
each side they must stay within steps · lr of the initial value. Style
targets 1e-5 relative; the style draws equal; the pricing's
``worth_iterations`` equal and its losses 1e-4 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.models.gram_attention import (
    gram_attention_init as j_gram_attention_init,
)
from heuristique_style_transfer_code_tpu.nn import transformer_net as jt
from heuristique_style_transfer_code_tpu.ops.gram import gram_matrix_nhwc as j_gram
from heuristique_style_transfer_code_tpu.ops.resize import IMAGENET_MEAN, IMAGENET_STD
from heuristique_style_transfer_code_tpu.tasks import fast_style as jf
from heuristique_style_transfer_code_tpu.tasks import style_transfer as jst
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    load_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.models.gram_attention import gram_attention_init
from heuristique_style_transfer_code_tpu_torch.nn import transformer_net as pt
from heuristique_style_transfer_code_tpu_torch.ops.gram import gram_matrix_nhwc
from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin
from heuristique_style_transfer_code_tpu_torch.tasks import fast_style as pf
from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes: one intra-op thread is as fast alone and keeps the
    test workers that share the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TRUNCATE, CROP, LR, STEPS, N_STYLES = 6, 32, 1e-3, 3, 3


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree):
    return {jax.tree_util.keystr(k): np.array(v, copy=True)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _zero_gradient_leaf(key: str) -> bool:
    """A bias whose true gradient is zero (see the module docstring)."""
    return key.endswith("['bias']") and ("['in_b']" in key or not (
        "['in" in key or key.startswith("['out']")))


def _cond_tree(seed=0):
    """A conditional JAX net whose per-style tables differ."""
    tree = _np_tree(jt.transformer_net_init(jax.random.PRNGKey(seed), width=4, n_res=1,
                                            n_styles=N_STYLES))
    rng = np.random.RandomState(seed)

    def perturb(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias"}:
                return {k: (v + 0.3 * rng.randn(*v.shape)).astype(np.float32)
                        for k, v in node.items()}
            return {k: perturb(v) for k, v in node.items()}
        if isinstance(node, list):
            return [perturb(v) for v in node]
        return node

    return perturb(tree)


@pytest.fixture(scope="module")
def setup():
    """The two packages' extract functions on the same truncate-6 encoder,
    a single-style and a conditional net, 3 content batches, 3 styles."""
    enc = _np_tree(j_gram_attention_init(jax.random.PRNGKey(0), TRUNCATE, 4, 4))
    model = load_jax_tree(gram_attention_init(None, TRUNCATE, 4, 4, device="cpu"), enc)
    rng = np.random.RandomState(0)
    return dict(
        jx=jst.make_extract_fn_gram_attention(enc, TRUNCATE, style_layers="all"),
        px=pst.make_extract_fn_gram_attention(model, TRUNCATE, style_layers="all"),
        model=model,
        single=_np_tree(jt.transformer_net_init(jax.random.PRNGKey(1), width=4, n_res=1)),
        cond=_cond_tree(),
        batches=[rng.randint(0, 256, (2, 36, 36, 3)).astype(np.uint8) for _ in range(STEPS)],
        styles=[rng.randint(0, 256, (40, 44, 3)).astype(np.uint8) for _ in range(N_STYLES)],
    )


def _onehots(n):
    return [pf._style_onehot(0, seen, n, N_STYLES, "balanced") for seen in range(STEPS)]


@pytest.fixture(scope="module")
def trajectories(setup):
    """Loss and parameters after every step, both packages, single-style
    (``make_fast_style_train_step``) and conditional
    (``make_multi_style_train_step``)."""
    out = {}
    jx, px = setup["jx"], setup["px"]
    for kind in ("single", "multi"):
        tree = setup["single"] if kind == "single" else setup["cond"]
        make_j = jf.make_fast_style_train_step if kind == "single" else \
            jf.make_multi_style_train_step
        make_p = pf.make_fast_style_train_step if kind == "single" else \
            pf.make_multi_style_train_step
        if kind == "single":
            j_targets = [jf.encode_style_grams(jx, setup["styles"][0], CROP)]
            p_targets = [pf.encode_style_grams(px, setup["styles"][0], CROP, "cpu")]
        else:
            j_stacks = jf.encode_style_gram_stacks(jx, setup["styles"], CROP)
            p_stacks = pf.encode_style_gram_stacks(px, setup["styles"], CROP, "cpu")
            w = _onehots(2)
            j_targets = [(jnp.asarray(w[i]), j_stacks) for i in range(STEPS)]
            p_targets = [(w[i], p_stacks) for i in range(STEPS)]
        j_init, j_step = make_j(jx, learning_rate=LR, crop=CROP)
        p_init, p_step = make_p(px, learning_rate=LR, crop=CROP)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        j_opt = j_init(params)
        net = pf.net_from_tree(tree, "cpu")
        p_opt = p_init(net)
        rows = []
        for i, b in enumerate(setup["batches"]):
            args_j = j_targets[0] if kind == "single" else j_targets[i]
            args_p = p_targets[0] if kind == "single" else p_targets[i]
            if kind == "single":
                params, j_opt, j_loss = j_step(params, j_opt, jnp.asarray(b), args_j)
                net, p_opt, p_loss = p_step(net, p_opt, b, args_p)
            else:
                params, j_opt, j_loss = j_step(params, j_opt, jnp.asarray(b), *args_j)
                net, p_opt, p_loss = p_step(net, p_opt, b, *args_p)
            rows.append((float(j_loss), float(p_loss), _flat(_np_tree(params)),
                         _flat(to_jax_tree(net))))
        out[kind] = (_flat(tree), rows)
    return out


@pytest.mark.parametrize("kind", ["single", "multi"])
@pytest.mark.parametrize("steps", [1, STEPS])
def test_train_steps_match_jax(trajectories, kind, steps):
    init, rows = trajectories[kind]
    for i, (j_loss, p_loss, _, _) in enumerate(rows[:steps]):
        assert abs(p_loss - j_loss) <= (1e-5 if i == 0 else 1e-3) * abs(j_loss), i
    _, _, j_params, p_params = rows[steps - 1]
    assert set(p_params) == set(j_params)
    move = steps * LR
    held = 0
    for key, want in j_params.items():
        got = p_params[key]
        assert got.shape == want.shape, key
        if _zero_gradient_leaf(key):
            for side in (got, want):
                assert np.abs(side - init[key]).max() <= move * (1 + 1e-4), key
            held += 1
        else:
            assert np.sqrt(np.mean(np.square(got - want))) <= 0.25 * move, key
            assert np.abs(got - init[key]).max() > 0.5 * LR, key  # it did move
    assert held == 8  # conv1-3, conv_a, conv_b, in_b, up1, up2


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_training_loss_gradients_match_jax(setup, kind):
    """The first step's loss and its gradient with respect to every net
    parameter: the port's ``_net_loss`` through autograd against
    ``jax.value_and_grad`` of the JAX step's loss, written out here as in
    ``tasks/fast_style.py`` (the step keeps it inside)."""
    from heuristique_style_transfer_code_tpu.data.augment import eval_preprocess as j_pre
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess

    jx, px, b = setup["jx"], setup["px"], setup["batches"][0]
    tree = setup["single"] if kind == "single" else setup["cond"]
    w = _onehots(2)[0] if kind == "multi" else None
    j_stacks = jf.encode_style_gram_stacks(jx, setup["styles"], CROP)
    p_stacks = pf.encode_style_gram_stacks(px, setup["styles"], CROP, "cpu")
    if kind == "single":
        j_targets = [s[:1] for s in j_stacks]
        p_targets = [s[:1] for s in p_stacks]
    else:
        j_targets = [jnp.einsum("bk,k...->b...", w, s) for s in j_stacks]
        p_targets = [torch.einsum("bk,k...->b...", torch.tensor(w), s) for s in p_stacks]

    def j_loss(params):
        images = j_pre(jnp.asarray(b), CROP)
        content = jax.lax.stop_gradient(jx(images)[0])
        out = jt.transformer_net_apply(params, images, None, style_weights=w, in_backend="xla")
        feats, grams = jx(out)
        style = 0.0
        for g, t in zip(grams, j_targets):
            style = style + jnp.mean(jnp.square(g - t))
        return style + jnp.mean(jnp.square(feats - content))

    params = jax.tree_util.tree_map(jnp.asarray, tree)
    want_loss, want = jax.jit(jax.value_and_grad(j_loss))(params)
    want = _flat(_np_tree(want))
    net = pf.net_from_tree(tree, "cpu")
    images = eval_preprocess(torch.as_tensor(b), CROP)
    loss = pf._net_loss(px, net, images, p_targets, (1.0, 1.0, 0.0), None,
                        None if w is None else torch.tensor(w))
    grads = torch.autograd.grad(loss, list(net.parameters()))
    got = _flat(to_jax_tree(net, dict(zip([n for n, _ in net.named_parameters()], grads))))
    assert abs(float(loss.detach()) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    largest = max(np.abs(g).max() for g in want.values())
    for key, g in want.items():
        if _zero_gradient_leaf(key):
            assert max(np.abs(g).max(), np.abs(got[key]).max()) <= 1e-5 * largest, key
        else:
            assert np.linalg.norm(got[key] - g) <= 1e-2 * np.linalg.norm(g), key


def test_loss_falls_over_the_steps(trajectories):
    for kind in ("single", "multi"):
        losses = [r[1] for r in trajectories[kind][1]]
        assert losses[-1] < losses[0], (kind, losses)


@pytest.mark.parametrize("conditional", [False, True])
def test_net_gradient_matches_jax(conditional):
    """The gradient of a fixed linear functional of the net's output with
    respect to every parameter, through the 15 norms' backward, against
    ``jax.grad`` of the JAX net (``in_backend="xla"``)."""
    tree = _cond_tree(1) if conditional else _np_tree(
        jt.transformer_net_init(jax.random.PRNGKey(2), width=4, n_res=1))
    rng = np.random.RandomState(4)
    x = rng.randn(2, 16, 16, 3).astype(np.float32)
    probe = rng.randn(2, 16, 16, 3).astype(np.float32)
    w = np.array([[1.0, 0.0, 0.0], [0.2, 0.3, 0.5]], np.float32) if conditional else None

    def j_loss(p):
        y = jt.transformer_net_apply(p, jnp.asarray(x), style_weights=w, in_backend="xla")
        return jnp.sum(y * probe)

    want = _flat(_np_tree(jax.jit(jax.grad(j_loss))(jax.tree_util.tree_map(jnp.asarray, tree))))
    net = pf.net_from_tree(tree, "cpu")
    y = pt.transformer_net_apply(net, torch.tensor(x), style_weights=w)
    grads = torch.autograd.grad((y * torch.tensor(probe)).sum(), list(net.parameters()))
    names = [n for n, _ in net.named_parameters()]
    got = _flat(to_jax_tree(net, dict(zip(names, grads))))
    for key, g in want.items():
        if _zero_gradient_leaf(key):
            continue
        scale = np.abs(g).max()
        assert np.abs(got[key] - g).max() <= 1e-4 * scale, key


def test_net_norms_go_through_instance_norm_function(monkeypatch):
    """A gradient through the classic depth (n_res 5) runs 15 norm
    forwards and 15 backwards; serving under ``inference_mode`` 15
    forwards only."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = kin.instance_norm_fwd, kin.instance_norm_bwd

    def counting_fwd(*a, **k):
        calls["fwd"] += 1
        return fwd(*a, **k)

    def counting_bwd(*a, **k):
        calls["bwd"] += 1
        return bwd(*a, **k)

    monkeypatch.setattr(kin, "instance_norm_fwd", counting_fwd)
    monkeypatch.setattr(kin, "instance_norm_bwd", counting_bwd)
    net = pt.transformer_net_init(torch.Generator().manual_seed(0), width=4, n_res=5,
                                  device="cpu")
    x = torch.randn(1, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    loss = pt.transformer_net_apply(net, x).square().mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    assert calls == {"fwd": 15, "bwd": 15}
    assert all(torch.isfinite(g).all() for g in grads)
    calls.update(fwd=0, bwd=0)
    with torch.inference_mode():
        pt.transformer_net_apply(net, x)
    assert calls == {"fwd": 15, "bwd": 0}


def test_style_targets_match_jax(setup):
    jx, px = setup["jx"], setup["px"]
    want = jf.encode_style_gram_stacks(jx, setup["styles"], CROP)
    got = pf.encode_style_gram_stacks(px, setup["styles"], CROP, "cpu")
    single = pf.encode_style_grams(px, setup["styles"][1], CROP, "cpu")
    assert len(got) == len(want) == 2  # layer1 and layer2
    for g, w, s in zip(got, want, single):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == torch.float32
        assert np.abs(g.numpy() - w).max() <= 1e-5 * np.abs(w).max()
        # the same image alone: another batch size, another conv summation order
        assert np.abs(s.numpy()[0] - g.numpy()[1]).max() <= 1e-6 * np.abs(w).max()


@pytest.mark.parametrize("n", [2, 7, 16])
def test_style_draws_equal_jax(n):
    """``balanced_style_indices`` and the per-step draws of
    ``train_multi_style`` (``default_rng([seed, step])``), balanced and
    uniform, against the JAX package's code on the same generators."""
    for s in (1, 3, 5):
        got = pf.balanced_style_indices(n, s, np.random.default_rng([7, n]))
        want = jf.balanced_style_indices(n, s, np.random.default_rng([7, n]))
        np.testing.assert_array_equal(got, want)
        counts = np.bincount(got, minlength=s)
        assert counts.max() - counts.min() <= 1
    for seen in range(4):
        rng = np.random.default_rng([3, seen])
        idx = jf.balanced_style_indices(n, N_STYLES, rng)
        np.testing.assert_array_equal(pf._style_onehot(3, seen, n, N_STYLES, "balanced"),
                                      np.eye(N_STYLES, dtype=np.float32)[idx])
        idx = np.random.default_rng([3, seen]).integers(0, N_STYLES, size=n)
        np.testing.assert_array_equal(pf._style_onehot(3, seen, n, N_STYLES, "uniform"),
                                      np.eye(N_STYLES, dtype=np.float32)[idx])


def test_training_loop_history_matches_jax(setup):
    """``train_fast_style`` over a list loader (2 epochs of 3 batches, a
    loss fetched every 2 steps and at the end) in both packages."""
    tree = setup["single"]
    kw = dict(epochs=2, crop=CROP, learning_rate=LR, log_every=2, log_fn=lambda *_: None)
    loader = [(b,) for b in setup["batches"]]
    _, want = jf.train_fast_style(jax.tree_util.tree_map(jnp.asarray, tree), setup["jx"],
                                  loader, setup["styles"][0], **kw)
    net = pf.net_from_tree(tree, "cpu")
    out, got = pf.train_fast_style(net, setup["px"], loader, setup["styles"][0], **kw)
    assert out is net and len(got) == len(want) == 5
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert not any(p.grad is not None for p in setup["model"].parameters())
    assert not any(p.requires_grad for p in setup["model"].encoder.parameters())


def test_mid_epoch_resume_requires_set_position(setup, tmp_path):
    net = pf.net_from_tree(setup["single"], "cpu")
    init, _ = pf._make_optimizer(LR)
    pf._save_net_inprogress(str(tmp_path), net, init(net), 0, 1, 1, [], "sig-x")
    with pytest.raises(ValueError, match="set_position"):
        pf.train_fast_style(net, setup["px"], [(setup["batches"][0],)] * 3,
                            setup["styles"][0], epochs=1, crop=CROP, save_dir=str(tmp_path),
                            resume=True, signature="sig-x", log_fn=lambda *_: None)


def test_inprogress_round_trip_is_exact(setup, tmp_path):
    """The in-progress file gives back the net and the Adam state bit for
    bit, and refuses another signature."""
    net = pf.net_from_tree(setup["cond"], "cpu")
    init, step = pf.make_multi_style_train_step(setup["px"], crop=CROP)
    opt = init(net)
    stacks = pf.encode_style_gram_stacks(setup["px"], setup["styles"], CROP, "cpu")
    step(net, opt, setup["batches"][0], _onehots(2)[0], stacks)
    pf._save_net_inprogress(str(tmp_path), net, opt, 1, 2, 3, [0.5, 0.25], "sig")
    st = pf._load_net_inprogress(str(tmp_path), "sig")
    other = pf.net_from_tree(setup["cond"], "cpu")
    other_opt = init(other)
    pf._restore(other, other_opt, st)
    for a, b in zip(net.parameters(), other.parameters()):
        assert torch.equal(a, b)
    assert other_opt["count"] == 1
    for key in ("mu", "nu"):
        for name, t in opt[key].items():
            assert torch.equal(t, other_opt[key][name])
    assert (int(st["epoch"]), int(st["step_in_epoch"]), int(st["seen"])) == (1, 2, 3)
    with pytest.raises(ValueError, match="does not match"):
        pf._load_net_inprogress(str(tmp_path), "other")
    pf.clear_net_inprogress(str(tmp_path))
    assert pf._load_net_inprogress(str(tmp_path), "sig") is None


def _identity_extract_jax(images):
    return images, [j_gram(images)]


def _identity_extract_port(images):
    return images, [gram_matrix_nhwc(images)]


def test_net_quality_and_worth_match_jax():
    """The net's per-image loss and its price in loop iterations
    (``compare_net_to_loop``) on the pixel-Gram objective, for a net
    trained briefly by the port and carried to JAX."""
    style01 = np.zeros((1, 8, 8, 3), np.float32)
    style01[:, ::2] = 1.0
    style = (style01 - IMAGENET_MEAN) / IMAGENET_STD
    j_grams = [j_gram(jnp.asarray(style, jnp.float32))]
    p_grams = [gram_matrix_nhwc(torch.tensor(style, dtype=torch.float32))]
    rng = np.random.RandomState(0)
    train_u8 = rng.randint(0, 256, (8, 12, 12, 3)).astype(np.uint8)
    held_u8 = rng.randint(0, 256, (4, 12, 12, 3)).astype(np.uint8)
    net = pt.transformer_net_init(torch.Generator().manual_seed(0), width=4, n_res=1,
                                  device="cpu")
    init, step = pf.make_fast_style_train_step(_identity_extract_port, content_weight=0.1,
                                               learning_rate=5e-3, crop=8)
    opt = init(net)
    for _ in range(40):
        step(net, opt, train_u8, p_grams)
    tree = to_jax_tree(net)
    kw = dict(crop=8, iteration_grid=(1, 5, 25), style_weight=1.0, content_weight=0.1,
              learning_rates=(0.01, 0.05))
    want = jf.compare_net_to_loop(_identity_extract_jax, jax.tree_util.tree_map(jnp.asarray, tree),
                                  jnp.asarray(held_u8), j_grams, **kw)
    got = pf.compare_net_to_loop(_identity_extract_port, net, held_u8, p_grams, **kw)
    per = pf.net_quality_per_image(_identity_extract_port, net, held_u8, p_grams, crop=8,
                                   content_weight=0.1)
    np.testing.assert_allclose(per.numpy(), want["net_loss_per_image"], rtol=1e-4)
    np.testing.assert_allclose(got["net_loss_per_image"], want["net_loss_per_image"], rtol=1e-4)
    for k in (1, 5, 25):
        np.testing.assert_allclose(got["loop_loss_mean"][k], want["loop_loss_mean"][k],
                                   rtol=1e-4)
    assert got["loop_best_lr"] == want["loop_best_lr"]
    assert got["learning_rates"] == want["learning_rates"]
    assert got["worth_iterations"] == want["worth_iterations"]
    assert 0 < got["worth_iterations"], got


def test_training_after_serving_in_inference_mode():
    """A forward served under ``inference_mode`` first (the reflect pads'
    cached index tensors made there) leaves a later gradient through the
    same shapes working."""
    net = pt.transformer_net_init(torch.Generator().manual_seed(3), width=4, n_res=1,
                                  device="cpu")
    x = torch.randn(1, 20, 20, 3, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        served = pt.transformer_net_apply(net, x)
    loss = pt.transformer_net_apply(net, x).square().mean()
    grads = torch.autograd.grad(loss, list(net.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)
    assert torch.equal(served, pt.transformer_net_apply(net, x).detach())
