"""The pooled Gram's backward (``pooled_gram_bwd``, its plain version and
``PooledGramFunction``) against ``jax.vjp`` of the JAX package's
``ops.gram.pooled_gram_nhwc`` (the XLA composition JAX differentiates), on
the same numpy inputs: S dividing C, overlapping bins (C % S != 0), C < S
(a channel in several bins) and S > 16 (the forward's "project" route).
The backward works from the forward's Y = F P^T (JAX's residual ``pf``):
the plain Y is held to JAX's ``pf``, and ``PooledGramFunction`` saves Y
alone, and only where a gradient flows.

Tolerances: f32 1e-5 of max|dF| (only the summation order differs); bf16
at 1.5x JAX's own bf16 error against its f32 result, by max and by RMS
(the XLA path rounds P and F P^T to bf16, the port keeps both in f32). The
CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.ops.gram import pooled_gram_nhwc as j_pooled
from heuristique_style_transfer_code_tpu.ops.pooling import adaptive_pool_matrix as j_pool_matrix
from heuristique_style_transfer_code_tpu_torch.ops import gram as tgram
from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as kgram

# (shape, S): S divides C; overlapping bins (C = 10, S = 7; C = 256, S = 7);
# C < S; S > 16 (the forward's project route) with C % S != 0
CASES = [((2, 5, 5, 64), 4), ((2, 3, 4, 10), 7), ((1, 4, 4, 256), 7), ((2, 3, 3, 5), 7),
         ((2, 4, 3, 40), 20)]


def _inputs(shape, s, seed):
    rng = np.random.RandomState(seed)
    x = np.maximum(rng.randn(*shape), 0).astype(np.float32)  # post-ReLU features
    dg = rng.randn(shape[0], s, s).astype(np.float32)  # not symmetric
    return x, dg


def _jax_vjp(x, dg, s, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda a: j_pooled(a, s), jnp.asarray(x, dtype))
    return np.asarray(vjp(jnp.asarray(dg, dtype))[0], np.float32)


@pytest.mark.parametrize("shape,s", CASES)
def test_plain_backward_matches_jax_vjp(shape, s):
    x, dg = _inputs(shape, s, 0)
    want = _jax_vjp(x, dg, s)
    n, h, w, c = shape
    y = kgram.pooled_gram_y_plain(torch.from_numpy(x).reshape(n, h * w, c), s)
    got = kgram.pooled_gram_bwd_plain(y, torch.from_numpy(dg), c,
                                      torch.float32).reshape(shape).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,s", CASES)
def test_function_gradient_matches_jax_vjp(shape, s):
    """``ops.gram.pooled_gram_nhwc`` is differentiable through
    ``PooledGramFunction``: its forward and its input gradient against
    JAX's."""
    x, dg = _inputs(shape, s, 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    g = tgram.pooled_gram_nhwc(xt, s)
    np.testing.assert_allclose(g.detach().numpy(), np.asarray(j_pooled(jnp.asarray(x), s)),
                               rtol=1e-4, atol=1e-5)
    (got,) = torch.autograd.grad(g, xt, torch.from_numpy(dg))
    want = _jax_vjp(x, dg, s)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape,s", [((2, 4, 4, 64), 7), ((2, 3, 4, 10), 7), ((2, 3, 3, 5), 7),
                                     ((1, 4, 4, 40), 20)])
def test_bf16_within_jax_own_bf16_error(shape, s):
    x, dg = _inputs(shape, s, 2)
    # both sides start from the same bf16-rounded inputs
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    dgb = np.asarray(jnp.asarray(dg, jnp.bfloat16), np.float32)
    ref = _jax_vjp(xb, dgb, s)
    jax_bf16 = _jax_vjp(xb, dgb, s, jnp.bfloat16)
    xt = torch.from_numpy(xb).to(torch.bfloat16).requires_grad_(True)
    (got,) = torch.autograd.grad(tgram.pooled_gram_nhwc(xt, s), xt,
                                 torch.from_numpy(dgb).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    scale, norm = np.abs(ref).max(), np.linalg.norm(ref)
    j_max, j_rms = np.abs(jax_bf16 - ref).max() / scale, np.linalg.norm(jax_bf16 - ref) / norm
    p_max, p_rms = np.abs(got - ref).max() / scale, np.linalg.norm(got - ref) / norm
    print(f"bf16 error (max, rms): port ({p_max:.2e}, {p_rms:.2e}), JAX ({j_max:.2e}, {j_rms:.2e})")
    assert p_max <= 1.5 * j_max and p_rms <= 1.5 * j_rms, (p_max, j_max, p_rms, j_rms)


def test_function_gradcheck_f64():
    f = torch.rand(2, 6, 10, dtype=torch.float64, generator=torch.Generator().manual_seed(0),
                   requires_grad=True)
    assert torch.autograd.gradcheck(lambda t: kgram.PooledGramFunction.apply(t, 7), (f,))


def test_plain_backward_does_not_count_launches():
    kgram.reset_launch_counts()
    f = torch.rand(2, 9, 8, requires_grad=True)
    kgram.PooledGramFunction.apply(f, 3).sum().backward()
    kgram.pooled_gram_bwd(kgram.pooled_gram_y_plain(f.detach(), 3), torch.randn(2, 3, 3), 8,
                          torch.float32)
    assert kgram.LAUNCHES == {name: 0 for name in kgram.KERNELS}
    assert "pooled_gram_bwd" in kgram.KERNELS


def test_non_cpu_tensor_never_takes_the_plain_backward():
    y = torch.empty(2, 9, 3, device="meta")
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        kgram.pooled_gram_bwd(y, torch.empty(2, 3, 3, device="meta"), 8, torch.float32)


def _count_calls(monkeypatch):
    """Counts of the wrappers ``PooledGramFunction`` calls."""
    calls = {"pooled_gram_fwd": 0, "pooled_gram_bwd": 0}
    for name in calls:
        real = getattr(kgram, name)

        def counted(*a, _real=real, _name=name, **k):
            calls[_name] += 1
            return _real(*a, **k)

        monkeypatch.setattr(kgram, name, counted)
    return calls


@pytest.mark.parametrize("truncate,stages", [(6, 2), (7, 3)])
def test_eval_forward_never_reaches_the_backward(monkeypatch, truncate, stages):
    """The family-2 eval forward takes one pooled Gram a stage and never
    the backward; a train step with the encoder trainable takes the
    backward once a stage; with the encoder frozen (``--freeze_layers``)
    none, as the Grams need no gradient."""
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention

    calls = _count_calls(monkeypatch)
    model = gram_attention_init(torch.Generator().manual_seed(0), truncate, 4, 4, device="cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        gram_attention_apply(model, x, truncate, 4, 4)
    with torch.no_grad():
        gram_attention_apply(model, x, truncate, 4, 4)
    gram_attention_apply(model, x, truncate, 4, 4)  # grad mode, no backward asked for
    assert calls == {"pooled_gram_fwd": 3 * stages, "pooled_gram_bwd": 0}

    cfg = GramAttentionConfig(batch_size=2, lr=0.01, truncate_layer=truncate,
                              gram_matrix_size=4)
    images = np.random.RandomState(2).randint(0, 256, (2, 40, 40, 3)).astype(np.uint8)
    labels = np.array([0, 3], np.int32)
    for freeze, want_bwd in ((False, stages), (True, 0)):
        calls.update(pooled_gram_fwd=0, pooled_gram_bwd=0)
        setup = setup_gram_attention(cfg, 4, [(None, None)], freeze_encoder=freeze,
                                     device="cpu")
        setup.train_step = _small_crop(setup, cfg)
        m, opt = setup.init(torch.Generator().manual_seed(0))
        setup.train_step(m, opt, images, labels)
        assert calls == {"pooled_gram_fwd": stages, "pooled_gram_bwd": want_bwd}, freeze


def _small_crop(setup, cfg):
    """The setup's train step at a 32-pixel crop (the CLI's is 224)."""
    from heuristique_style_transfer_code_tpu_torch.data.augment import make_augment_fn
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.train.train_loop import make_train_step_body

    def forward_train(model, images):
        model.train()
        return gram_attention_apply(model, images, cfg.truncate_layer, cfg.gram_matrix_size,
                                    4)[1]

    return make_train_step_body(forward_train, setup.optimizer,
                                make_augment_fn([(None, None)], crop=32))


@pytest.mark.parametrize("shape,s", CASES)
def test_plain_y_matches_jax_pf(shape, s):
    """The plain Y is JAX's residual ``pf`` (ops/gram.py:73-75) in f32."""
    x, _ = _inputs(shape, s, 3)
    n, h, w, c = shape
    f = jnp.asarray(x).reshape(n, h * w, c)
    want = np.asarray(jnp.einsum("nsc,oc->nso", f, jnp.asarray(j_pool_matrix(c, s))))
    got = kgram.pooled_gram_y_plain(torch.from_numpy(x).reshape(n, h * w, c), s).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("shape,s", [((2, 4, 4, 64), 7), ((2, 3, 4, 10), 7), ((2, 3, 3, 5), 7),
                                     ((1, 4, 4, 40), 20)])
def test_plain_y_within_bf16_of_jax_pf(shape, s):
    """From the same bf16 inputs the port's Y stays f32 while JAX rounds P
    and ``pf`` to bf16: within two bf16 roundings (2 x 2^-8) of each
    element."""
    x, _ = _inputs(shape, s, 4)
    n, h, w, c = shape
    xb = jnp.asarray(x, jnp.bfloat16).reshape(n, h * w, c)
    want = np.asarray(j_pooled_pf(xb, s), np.float32)
    got = kgram.pooled_gram_y_plain(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16), s)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2 * 2.0 ** -8,
                               atol=1e-6 * np.abs(want).max())


def j_pooled_pf(f, s):
    """JAX's ``pf`` as ``pooled_gram_nhwc`` forms it on its XLA path."""
    p = jnp.asarray(j_pool_matrix(f.shape[-1], s)).astype(f.dtype)
    pet = jnp.float32 if f.dtype == jnp.float32 else None
    return jnp.einsum("nsc,oc->nso", f, p, preferred_element_type=pet).astype(f.dtype)


@pytest.mark.parametrize("shape,s", CASES)
def test_function_saves_y_and_not_f(shape, s):
    """Where a gradient flows ``PooledGramFunction`` saves one tensor, Y
    (N, HW, S) in f32, and nothing of f's (N, HW, C) shape; its backward
    from Y is the VJP."""
    x, dg = _inputs(shape, s, 5)
    n, h, w, c = shape
    f = torch.from_numpy(x).reshape(n, h * w, c).requires_grad_(True)
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        g = kgram.PooledGramFunction.apply(f, s)
    assert saved == [((n, h * w, s), torch.float32)]
    (got,) = torch.autograd.grad(g, f, torch.from_numpy(dg))
    want = _jax_vjp(x, dg, s).reshape(n, h * w, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["inference_mode", "no_grad", "no_input_grad"])
def test_function_asks_for_no_y_without_a_gradient(monkeypatch, mode):
    """Without a gradient to flow the forward writes no Y and saves
    nothing."""
    asked = []
    real = kgram.pooled_gram_fwd

    def spy(*a, **k):
        asked.append(k.get("return_y", False))
        return real(*a, **k)

    monkeypatch.setattr(kgram, "pooled_gram_fwd", spy)
    saved = []
    f = torch.rand(2, 9, 8)
    ctx = {"inference_mode": torch.inference_mode, "no_grad": torch.no_grad}.get(mode)
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        if ctx is None:
            g = kgram.PooledGramFunction.apply(f, 3)
        else:
            with ctx():
                g = kgram.PooledGramFunction.apply(f, 3)
    assert asked == [False] and saved == [] and g.shape == (2, 3, 3)


def test_family2_paths_ask_for_y_only_when_training_the_encoder(monkeypatch):
    """The family-2 eval forward and a train step with the encoder frozen
    ask ``pooled_gram_fwd`` for no Y; a step that trains the encoder asks
    once a stage."""
    from heuristique_style_transfer_code_tpu_torch.config.schema import GramAttentionConfig
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply,
        gram_attention_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.factories import setup_gram_attention

    asked = []
    real = kgram.pooled_gram_fwd

    def spy(*a, **k):
        asked.append(k.get("return_y", False))
        return real(*a, **k)

    monkeypatch.setattr(kgram, "pooled_gram_fwd", spy)
    truncate, stages = 6, 2
    model = gram_attention_init(torch.Generator().manual_seed(0), truncate, 4, 4, device="cpu")
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        gram_attention_apply(model, x, truncate, 4, 4)
    with torch.no_grad():
        gram_attention_apply(model, x, truncate, 4, 4)
    assert asked == [False] * 2 * stages
    cfg = GramAttentionConfig(batch_size=2, lr=0.01, truncate_layer=truncate,
                              gram_matrix_size=4)
    images = np.random.RandomState(2).randint(0, 256, (2, 40, 40, 3)).astype(np.uint8)
    labels = np.array([0, 3], np.int32)
    for freeze, want in ((True, [False] * stages), (False, [True] * stages)):
        asked.clear()
        setup = setup_gram_attention(cfg, 4, [(None, None)], freeze_encoder=freeze,
                                     device="cpu")
        setup.train_step = _small_crop(setup, cfg)
        m, opt = setup.init(torch.Generator().manual_seed(0))
        setup.train_step(m, opt, images, labels)
        assert asked == want, freeze


@pytest.mark.parametrize("hw,c,s,es", [(3136, 256, 7, 4), (784, 512, 7, 4), (196, 1024, 7, 4),
                                       (3136, 256, 7, 2), (143, 10, 7, 4), (25, 5, 7, 2),
                                       (143, 200, 24, 4), (63, 203, 64, 4), (49, 24576, 7, 4),
                                       (1, 3, 64, 2), (4, 40000, 7, 4)])
def test_pooled_gram_bwd_plan_covers_every_row_and_channel(hw, c, s, es):
    """The kernel's tiles cover every row of every image once, in order,
    none crossing an image or longer than tile_rows; its mode is "bulk"
    where C fills 16-byte groups and the two staged tiles fit, else
    "scalar"; the Y ring, z, M, the group table (and the staged tiles) fit
    in the H100 SXM's 227 KB; each 16-byte group's first bin and bin count
    are those of ``_pool_bins``."""
    n = 3
    plan = kgram._pooled_gram_bwd_plan(n, hw, c, s, es, 132)
    assert 1 <= plan.tile_rows <= 64 and 1 <= plan.blocks <= n * -(-hw // plan.tile_rows)
    unstaged = kgram._pgb_smem("scalar", c, s, plan.tile_rows, es) + kgram._PGB_STATIC_SMEM
    fits = unstaged + 2 * plan.tile_rows * c * es <= 227 * 1024
    assert (plan.mode == "bulk") == (c * es % 16 == 0 and fits)
    assert plan.smem == kgram._pgb_smem(plan.mode, c, s, plan.tile_rows, es)
    assert plan.smem + kgram._PGB_STATIC_SMEM <= 227 * 1024
    seen = []
    for tiles in kgram._pgb_tiles(n, hw, plan.tile_rows, plan.blocks):
        for image, r0, r1 in tiles:
            assert 0 <= r0 < r1 <= hw and r1 - r0 <= plan.tile_rows
            seen.extend(image * hw + r for r in range(r0, r1))
    assert seen == list(range(n * hw))
    v = 16 // es
    bins = kgram._pool_bins(c, s)
    table = kgram._pgb_group_bins(c, s, es)
    assert len(table) == -(-c // v)
    for g, (o0, count) in enumerate(table):
        group = range(g * v, min(g * v + v, c))
        touching = [o for o, (lo, hi, _) in enumerate(bins) if lo < group[-1] + 1 and hi > g * v]
        assert touching == list(range(o0, o0 + count))
        assert bins[o0][0] <= g * v < bins[o0][1]  # the first channel's first bin
