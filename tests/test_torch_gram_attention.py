"""The weight bridge and the family-2 forward: a JAX ``gram_attention_init``
tree (its batch-norm statistics randomised, so that a swapped mean/var or
scale/bias would show) goes through ``checkpoint/convert.py`` into the
port, and both packages run the same 64 px input in eval. Tolerance: f32,
atol 1e-4 on embeddings and logits of order 1 (conv summation order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.models.gram_attention import (
    gram_attention_apply as j_apply,
)
from heuristique_style_transfer_code_tpu.models.gram_attention import (
    gram_attention_init as j_init,
)
from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import _prune_encoder
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    from_jax_tree,
    load_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.models.gram_attention import (
    gram_attention_apply,
    gram_attention_init,
)

S, CLASSES = 4, 4


@functools.lru_cache(maxsize=None)
def _full_tree(seed):
    return jax.tree_util.tree_map(np.asarray, j_init(jax.random.PRNGKey(seed), 8, CLASSES, S))


def _jax_tree(truncate, seed=0):
    """``gram_attention_init``'s tree at ``truncate``: one truncate-8 draw,
    pruned as ``_prune_encoder`` prunes it."""
    full = _full_tree(seed)
    tree = dict(full, encoder=_prune_encoder(full["encoder"], truncate))
    rng = np.random.RandomState(seed)

    def randomise_bn(node):
        if isinstance(node, dict):
            if set(node) == {"scale", "bias", "mean", "var"}:
                c = node["scale"].shape[0]
                return {"scale": rng.uniform(0.5, 1.0, c).astype(np.float32),
                        "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                        "mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                        "var": rng.uniform(1.0, 2.0, c).astype(np.float32)}
            return {k: randomise_bn(v) for k, v in node.items()}
        if isinstance(node, list):
            return [randomise_bn(v) for v in node]
        return node

    return randomise_bn(tree)


def _port(tree, truncate):
    return load_jax_tree(gram_attention_init(None, truncate, CLASSES, S, device="cpu"), tree)


@pytest.mark.parametrize("truncate", [4, 6, 8])
def test_bridge_and_forward_match_jax(truncate):
    tree = _jax_tree(truncate)
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    j_emb, j_logits, _ = j_apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                                 truncate, S, CLASSES)
    model = _port(tree, truncate)
    with torch.inference_mode():
        emb, logits = gram_attention_apply(model, torch.from_numpy(x), truncate, S, CLASSES)
    assert emb.shape == (2, S * S) and logits.shape == (2, CLASSES)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), rtol=1e-4, atol=1e-4)
    if truncate <= 4:  # no stage ran: the reference's zero head
        assert not logits.any() and not emb.any()
    else:
        assert np.abs(np.asarray(j_logits)).max() > 1e-2  # a real, non-zero comparison


def test_bridge_layouts_and_roundtrip():
    tree = _jax_tree(5, seed=2)
    sd = from_jax_tree(tree)
    k = tree["encoder"]["layer1"][0]["conv2"]["kernel"]  # HWIO
    np.testing.assert_array_equal(sd["encoder.layer1.0.conv2.weight"].numpy(),
                                  np.transpose(k, (3, 2, 0, 1)))
    np.testing.assert_array_equal(sd["classifier.weight"].numpy(), tree["classifier"]["kernel"].T)
    np.testing.assert_array_equal(sd["encoder.bn1.running_var"].numpy(), tree["encoder"]["bn1"]["var"])
    np.testing.assert_array_equal(sd["attention.in_proj_weight"].numpy(),
                                  tree["attention"]["in_proj_weight"])
    back = to_jax_tree(_port(tree, 5))
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])  # noqa: E731
    a, b = flat(tree), flat(back)
    assert set(map(str, a)) == set(map(str, b))
    for key in a:
        np.testing.assert_array_equal(a[key], b[key])


def test_bridge_fails_on_missing_or_left_over_leaves():
    tree = _jax_tree(5, seed=3)
    model = gram_attention_init(None, 5, CLASSES, S, device="cpu")
    extra = dict(tree, encoder=dict(tree["encoder"], layer2=tree["encoder"]["layer1"]))
    with pytest.raises(KeyError, match="left over"):
        load_jax_tree(model, extra)
    missing = dict(tree, classifier={"kernel": tree["classifier"]["kernel"]})
    with pytest.raises(KeyError, match="missing"):
        load_jax_tree(model, missing)
    wrong = dict(tree, classifier={"kernel": tree["classifier"]["kernel"][:3],
                                   "bias": tree["classifier"]["bias"]})
    with pytest.raises(ValueError, match="shape"):
        load_jax_tree(model, wrong)
