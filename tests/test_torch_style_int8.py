"""The style loop's ``weights_int8`` in the port (``tasks/style_transfer.py``:
``make_feature_fn_gram_attention``, ``make_extract_fn_gram_attention``,
``make_gram_fn_gram_attention``) against the JAX package's
(``_quantize_conv_kernels``, ``_dequantize_conv_kernels``), on the CPU.

- The int8 values and f32 scales of every conv weight equal JAX's
  exactly, in f32 and bf16 (JAX quantises the tree cast to the compute
  dtype; so does the port).
- The quantised Grams stay within JAX's own bound of the f32 ones
  (``tests/test_content_style.py``: relative L2 < 0.1 and > 0).
- The port's quantised features, Grams and content+style extraction equal
  JAX's quantised ones on the same weights and images: relative L2 1e-5
  in f32 (the same dequantised weights; oneDNN's and XLA's convolutions
  sum in other orders), and pixel gradients flow through the dequantised
  convs.

Sizes: truncate 5 (the stem and layer1), S 4, 64-pixel images, b2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten
from heuristique_style_transfer_code_tpu_torch.models.gram_attention import gram_attention_init
from heuristique_style_transfer_code_tpu_torch.tasks import style_transfer as pst


@pytest.fixture(scope="module")
def weights():
    from heuristique_style_transfer_code_tpu.models.gram_attention import (
        gram_attention_init as j_init,
    )

    variables = j_init(jax.random.PRNGKey(0), 5, 4, 4)
    model = gram_attention_init(None, 5, 4, 4, device="cpu")
    load_jax_tree(model, jax.tree_util.tree_map(np.asarray, variables))
    return variables, model


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_values_and_scales_equal_jax(weights, dtype):
    from heuristique_style_transfer_code_tpu.core.dtypes import Policy
    from heuristique_style_transfer_code_tpu.tasks.style_transfer import _quantize_conv_kernels

    variables, model = weights
    enc = variables["encoder"]
    if dtype == "bfloat16":
        enc = Policy(compute_dtype=jnp.bfloat16).cast_to_compute(enc)
    want = _flatten(jax.tree_util.tree_map(np.asarray, _quantize_conv_kernels(enc)))
    quantised = pst.make_feature_fn_gram_attention(
        model, 5, layers=5, compute_dtype=getattr(torch, dtype), weights_int8=True).quantised
    assert all(q.dtype == torch.int8 and s.dtype == torch.float32
               for q, s in quantised.values())
    ints = _flatten(to_jax_tree(model.encoder, {n: q for n, (q, _) in quantised.items()}))
    scales = _flatten(to_jax_tree(model.encoder, {n: s[:, None, None, None]
                                                  for n, (_, s) in quantised.items()}))
    assert {k + "/int8" for k in ints} == {k for k in want if k.endswith("/int8")}
    for key, q in ints.items():
        np.testing.assert_array_equal(q.astype(np.int8), want[key + "/int8"], err_msg=key)
        np.testing.assert_array_equal(scales[key].reshape(-1), want[key + "/scale"], err_msg=key)


def test_grams_close_to_f32(weights, images):
    _, model = weights
    x = torch.from_numpy(images)
    g_f32 = pst.make_gram_fn_gram_attention(model, 5, layers=5)(x)[0]
    g_q = pst.make_gram_fn_gram_attention(model, 5, layers=5, weights_int8=True)(x)[0]
    rel = _rel(g_q.detach(), g_f32.detach())
    assert 0.0 < rel < 0.1, rel


def test_quantised_features_and_grams_match_jax(weights, images):
    from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
        make_feature_fn_gram_attention as j_feature,
    )
    from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
        make_gram_fn_gram_attention as j_gram,
    )

    variables, model = weights
    x = torch.from_numpy(images)
    want_f = j_feature(variables, 5, layers=5, weights_int8=True)(jnp.asarray(images))
    want_g = j_gram(variables, 5, layers=5, weights_int8=True)(jnp.asarray(images))[0]
    got_f = pst.make_feature_fn_gram_attention(model, 5, layers=5, weights_int8=True)(x)
    got_g = pst.make_gram_fn_gram_attention(model, 5, layers=5, weights_int8=True)(x)[0]
    assert _rel(got_f.detach(), want_f) < 1e-5
    assert _rel(got_g.detach(), want_g) < 1e-5
    # the model's own encoder keeps its f32 weights
    assert all(p.dtype == torch.float32 for p in model.encoder.parameters())


def test_content_style_extract_quantised_matches_jax(weights, images):
    from heuristique_style_transfer_code_tpu.tasks.style_transfer import (
        make_extract_fn_gram_attention as j_extract,
    )

    variables, model = weights
    want_f, want_g = j_extract(variables, 5, layers=5, style_layers="all",
                               weights_int8=True)(jnp.asarray(images))
    extract = pst.make_extract_fn_gram_attention(model, 5, layers=5, style_layers="all",
                                                 weights_int8=True)
    noise = torch.from_numpy(np.random.RandomState(2).randn(*images.shape).astype(np.float32))
    feats, grams = extract(torch.from_numpy(images))
    assert _rel(feats, want_f) < 1e-5
    assert len(grams) == len(want_g)
    for g, w in zip(grams, want_g):
        assert _rel(g, w) < 1e-5
    # pixel gradients flow through the dequantised convs; no weight gradient
    pixels = noise.clone().requires_grad_(True)
    f, gs = extract(pixels)
    (grad,) = torch.autograd.grad(f.square().mean() + sum(g.square().mean() for g in gs), pixels)
    assert float(grad.abs().max()) > 0
    assert not any(p.requires_grad for p in model.encoder.parameters())
