"""``--qat_steps``: the port's ``nn/resnet_qat.py`` and ``train/qat.py``
against the JAX package's, on the CPU.

- ``fake_quant``'s forward and its clipped straight-through gradient
  equal ``jax.vjp``'s, per tensor and per channel;
- ``qat_resnet50_apply`` in float64 on both sides (JAX under
  ``jax.enable_x64``; the input on the input scale's grid, so JAX's cast
  of it to f32 is exact): features and family-1 logits within 1e-9
  relative, the gradients of a loss on the logits within 1e-6 (read back
  in f32), the family-2 pooled Grams, embeddings and logits within 1e-6
  (the port's pooled Gram projects onto its bins in f32 whatever the
  input's type, as its kernel does); f32 would compare each side's own
  rounding through every fake-quant step;
- one ``qat_finetune`` step at lr 0.05 (truncate 4: the stem) against
  JAX's run eagerly (``jax.disable_jit``), float64 both sides: each leaf's move within
  1e-6 by relative L2, the same printed line, the batch-norm running
  statistics frozen; then 2 steps at the CLI's ``--qat_lr`` (1e-4) in f32
  against JAX's ``qat_finetune`` as it ships (jit-compiled): the weights
  within 1e-5 and the same line. The moves themselves cannot be held
  tighter across packages: each output channel's largest folded weight
  lies on the clip's tie (k / s = ±127, where the gradient is halved),
  and the last bit of k / s (jit-compiled XLA, another summation order a
  step earlier) puts it inside, on, or just outside the tie, where the
  gradient is whole, halved or 0.

Sizes: truncate 5, dim 16, 4 classes, b4 at 32-64 px; family 2 at S 4."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten
from heuristique_style_transfer_code_tpu_torch.nn import resnet_qat as pqat

S_IN = 2.0 ** -5  # x / S_IN is exact in f32 and f64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps the test workers that share
    the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("per_channel", [False, True])
def test_fake_quant_and_its_gradient_match_jax(per_channel):
    from heuristique_style_transfer_code_tpu.nn.resnet_qat import fake_quant

    rng = np.random.RandomState(0)
    x = (rng.randn(3, 5, 4, 6) * 4).astype(np.float32)
    scale = (rng.rand(6).astype(np.float32) * 0.05 + 0.01) if per_channel else 0.03
    g = rng.randn(*x.shape).astype(np.float32)
    want, vjp = jax.vjp(lambda t: fake_quant(t, jnp.asarray(scale)), jnp.asarray(x))
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pqat.fake_quant(xt, torch.from_numpy(np.asarray(scale)) if per_channel else scale)
    (got_g,) = torch.autograd.grad(got, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert np.array_equal(got_g.numpy(), np.asarray(want_g))
    assert (got_g.numpy() == 0).any() and (got_g.numpy() == g).any()  # clipped and passed


def _scales(truncate):
    """A scale tree (input on the S_IN grid; the others plausible
    post-ReLU ranges) for layer1 (and layer2)."""
    rng = np.random.RandomState(3)
    scales = {"input": S_IN, "stem": 0.03}
    for name, blocks in (("layer1", 3), ("layer2", 4))[: truncate - 4]:
        scales[name] = [{k: float(rng.rand() * 0.02 + 0.02) for k in ("h1", "h2", "out")}
                        for _ in range(blocks)]
    return scales


def _grid_input(seed, n, hw):
    rng = np.random.RandomState(seed)
    return (rng.randint(-127, 128, (n, hw, hw, 3)) * S_IN).astype(np.float32)


def _randomised(model, seed):
    """``model`` with random batch norms (so the folds do real work), and
    its JAX-layout tree."""
    tree = to_jax_tree(model)
    rng = np.random.RandomState(seed)

    def walk(node):
        if isinstance(node, dict):
            if set(node) >= {"scale", "bias", "mean", "var"}:
                c = np.shape(node["scale"])[0]
                return {"scale": (rng.rand(c) + 0.5).astype(np.float32),
                        "bias": (rng.randn(c) * 0.1).astype(np.float32),
                        "mean": (rng.randn(c) * 0.1).astype(np.float32),
                        "var": (rng.rand(c) + 0.5).astype(np.float32)}
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    tree = walk(tree)
    return load_jax_tree(model, tree), tree


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)


def _j_scales(scales):
    """The scales as float64 scalars: JAX's first fake-quant then runs in
    float64 on its f32 input (exact on the grid) and every later op does."""
    return jax.tree_util.tree_map(lambda s: jnp.float64(s), scales)


def test_family1_qat_forward_and_gradients_match_jax_in_float64():
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
        combined_apply_qat as j_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply_qat,
        truncated_resnet50_init,
    )

    t = 5
    model, tree = _randomised(
        truncated_resnet50_init(torch.Generator().manual_seed(1), t, 4, 16, device="cpu"), 2)
    model = model.double()
    scales = _scales(t)
    x = _grid_input(4, 4, 32)
    w = np.random.RandomState(5).randn(4, 4)
    logits = combined_apply_qat(model.moco, model.classifier, scales,
                                torch.from_numpy(x).double(), t)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad((logits * torch.from_numpy(w)).sum(),
                                [p for _, p in model.named_parameters()])
    got_g = _flatten(to_jax_tree(model, dict(zip(names, grads))))
    with jax.enable_x64():
        v = _f64(tree)

        def f(v):
            return j_apply(v["moco"], v["classifier"], _j_scales(scales), jnp.asarray(x), t)

        want, vjp = jax.vjp(f, v)
        (want_g,) = vjp(jnp.asarray(w))
        want = np.asarray(want)
        want_g = _flatten(jax.tree_util.tree_map(np.asarray, want_g))
    np.testing.assert_allclose(logits.detach().numpy(), want, rtol=1e-9, atol=1e-12)
    for key, g in got_g.items():
        # to_jax_tree reads back in f32: compare within its rounding
        np.testing.assert_allclose(g, want_g[key], rtol=1e-6,
                                   atol=1e-6 * np.abs(want_g[key]).max() + 1e-12, err_msg=key)
    for key in want_g:
        if key.endswith(("/mean", "/var")):
            assert not np.asarray(want_g[key]).any(), key  # frozen statistics


@pytest.mark.parametrize("truncate", [5, 6])
def test_family2_qat_twin_matches_jax_in_float64(truncate):
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_apply_qat as j_apply,
    )
    from heuristique_style_transfer_code_tpu.nn.resnet_qat import (
        qat_resnet50_apply as j_encoder,
    )
    from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
        gram_attention_apply_qat,
        gram_attention_init,
    )

    s = 4
    model, tree = _randomised(
        gram_attention_init(torch.Generator().manual_seed(6), truncate, 4, s, device="cpu"), 7)
    model = model.double()
    scales = _scales(truncate)
    x = _grid_input(8, 4, 32)
    with torch.no_grad():
        x64 = torch.from_numpy(x).double()
        feats, grams = pqat.qat_resnet50_apply(model.encoder, scales, x64, truncate,
                                               collect_grams=True, gram_pool_size=s)
        emb, logits = gram_attention_apply_qat(model, scales, x64, truncate, s, 4)
    with jax.enable_x64():
        v = _f64(tree)
        j_feats, j_grams = jax.jit(lambda v, x: j_encoder(
            v["encoder"], _j_scales(scales), x, truncate, collect_grams=True,
            gram_pool_size=s))(v, jnp.asarray(x))
        j_emb, j_logits = jax.jit(lambda v, x: j_apply(v, _j_scales(scales), x, truncate, s, 4))(
            v, jnp.asarray(x))
        outs = [np.asarray(a) for a in (j_feats, *j_grams, j_emb, j_logits)]
    # the features to float64 rounding; from the Grams on 1e-6: the
    # pooled Gram's plain version projects onto its bins in f32, as the
    # kernel does, for a float64 input too
    for i, (got, want) in enumerate(zip([feats, *grams, emb, logits], outs)):
        assert got.dtype == torch.float64
        tol = 1e-9 if i == 0 else 1e-6
        np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def _finetune_pair(steps, lr, float64, t=5):
    """The port's and JAX's ``qat_finetune`` from the same family-1
    weights (truncate 5, random batch norms) on the same two labelled
    batches (a pad entry in the first): (port model, its start state,
    JAX's result as a state dict, the port's printed line, JAX's)."""
    import contextlib

    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
        combined_apply_qat as j_apply,
    )
    from heuristique_style_transfer_code_tpu.train.qat import qat_finetune as j_finetune
    from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import from_jax_tree
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply_qat,
        truncated_resnet50_init,
    )
    from heuristique_style_transfer_code_tpu_torch.train.qat import qat_finetune

    model, tree = _randomised(
        truncated_resnet50_init(torch.Generator().manual_seed(9), t, 4, 16, device="cpu"), 10)
    dtype = torch.float64 if float64 else torch.float32
    model = model.to(dtype)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    scales = _scales(t)
    batches = [(_grid_input(11 + i, 4, 32), np.array([0, 3, -1, 2], np.int32) if i == 0
                else np.array([1, 1, 2, 0], np.int32)) for i in range(2)]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        qat_finetune(model, lambda m, x: combined_apply_qat(m.moco, m.classifier, scales, x, t),
                     [(torch.from_numpy(x).to(dtype), torch.from_numpy(y)) for x, y in batches],
                     steps, lr)
    port_line = buf.getvalue()
    buf = io.StringIO()
    x64 = jax.enable_x64() if float64 else contextlib.nullcontext()
    eager = jax.disable_jit() if float64 else contextlib.nullcontext()
    with x64, eager, contextlib.redirect_stdout(buf):
        v = _f64(tree) if float64 else jax.tree_util.tree_map(jnp.asarray, tree)
        sc = _j_scales(scales) if float64 else scales
        v = j_finetune(v, lambda v, x: j_apply(v["moco"], v["classifier"], sc, x, t),
                       [(jnp.asarray(x), jnp.asarray(y)) for x, y in batches], steps, lr)
        want = from_jax_tree(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), v))
    return model, start, want, port_line, buf.getvalue()


def test_qat_finetune_step_matches_eager_jax_in_float64():
    model, start, want, port_line, jax_line = _finetune_pair(1, 0.05, True, t=4)
    assert port_line == jax_line and port_line.startswith("QAT fine-tune: 1 pas, perte ")
    state = model.state_dict()
    for key, w in want.items():
        if "running" in key:  # frozen
            assert torch.equal(state[key], start[key]) and torch.equal(w, start[key]), key
            continue
        move, j_move = state[key] - start[key], w - start[key]
        assert float(j_move.norm()) > 0, key
        assert float((move - j_move).norm()) <= 1e-6 * float(j_move.norm()), key


def test_qat_finetune_matches_jax_over_two_steps():
    model, start, want, port_line, jax_line = _finetune_pair(2, 1e-4, False)
    assert port_line == jax_line and port_line.startswith("QAT fine-tune: 2 pas, perte ")
    state = model.state_dict()
    moved = 0
    for key, w in want.items():
        np.testing.assert_allclose(state[key].double().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
        moved += not torch.equal(state[key], start[key])
    assert moved > 10
