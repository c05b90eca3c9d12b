"""Family 1 on the port against the JAX package: the global average pool,
the encoder's output channels, the weight bridge on the ``{moco,
classifier}`` tree in both directions, and ``truncated_moco_apply`` /
``combined_apply`` at truncate 5, 6 and 9 on 32 px inputs at b2. A JAX
``truncated_moco_init`` tree (batch-norm statistics randomised, so that a
swapped mean/var or scale/bias would show) goes through the bridge.
Tolerances: f32 rtol/atol 1e-4 (conv summation order); bf16 5e-2 against
JAX's cast path (images cast to bf16, parameters cast at each op)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.models import truncated_resnet50 as J
from heuristique_style_transfer_code_tpu.nn.resnet import (
    truncated_feature_channels as j_feature_channels,
)
from heuristique_style_transfer_code_tpu.ops.pooling import global_avg_pool as j_gap
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    from_jax_tree,
    load_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.models import truncated_resnet50 as T
from heuristique_style_transfer_code_tpu_torch.nn.resnet import (
    ResNet50Encoder,
    resnet50_apply,
    truncated_feature_channels,
)
from heuristique_style_transfer_code_tpu_torch.ops.pooling import global_avg_pool

DIM, CLASSES = 16, 4
F32 = dict(rtol=1e-4, atol=1e-4)
BF16 = dict(rtol=5e-2, atol=5e-2)


def _randomise_bn(node, rng):
    if isinstance(node, dict):
        if set(node) == {"scale", "bias", "mean", "var"}:
            c = node["scale"].shape[0]
            return {"scale": rng.uniform(0.5, 1.0, c).astype(np.float32),
                    "bias": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                    "mean": rng.uniform(-0.1, 0.1, c).astype(np.float32),
                    "var": rng.uniform(1.0, 2.0, c).astype(np.float32)}
        return {k: _randomise_bn(v, rng) for k, v in node.items()}
    if isinstance(node, list):
        return [_randomise_bn(v, rng) for v in node]
    return node


@functools.lru_cache(maxsize=None)
def _full_tree():
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    tree = {"moco": J.truncated_moco_init(k1, 9, dim=DIM),
            "classifier": J.classifier_init(k2, DIM, CLASSES)}
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_tree(truncate):
    """``truncated_moco_init``'s tree at ``truncate``: one truncate-9 draw,
    its encoder pruned as ``_prune_encoder`` prunes it, an fc of the
    truncation's width drawn from numpy."""
    full = _full_tree()
    rng = np.random.RandomState(truncate)
    feat = j_feature_channels(truncate)
    bound = 1.0 / feat ** 0.5
    fc = {"kernel": rng.uniform(-bound, bound, (feat, DIM)).astype(np.float32),
          "bias": rng.uniform(-bound, bound, DIM).astype(np.float32)}
    tree = {"moco": {"encoder": J._prune_encoder(full["moco"]["encoder"], truncate), "fc": fc},
            "classifier": full["classifier"]}
    return _randomise_bn(tree, rng)


def _port(truncate):
    model = T.truncated_resnet50_init(None, truncate, CLASSES, DIM, device="cpu")
    return load_jax_tree(model, _jax_tree(truncate))


def _x(seed=1):
    return np.random.RandomState(seed).randn(2, 32, 32, 3).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_avg_pool_matches_jax(dtype):
    x = np.random.RandomState(0).randn(3, 5, 7, 9).astype(np.float32)
    want = np.asarray(j_gap(jnp.asarray(x).astype(dtype)).astype(jnp.float32))
    got = global_avg_pool(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, 9)
    np.testing.assert_allclose(got.float().numpy(), want, **(F32 if dtype == "float32" else BF16))


def test_feature_channels_match_jax():
    assert [truncated_feature_channels(t) for t in range(10)] == [
        j_feature_channels(t) for t in range(10)]


@pytest.mark.parametrize("truncate", [5, 6, 9])
def test_bridge_round_trips_the_family1_tree(truncate):
    tree = _jax_tree(truncate)
    sd = from_jax_tree(tree)
    # the 2-D fc kernels are (in, out) in JAX and (out, in) in the port
    np.testing.assert_array_equal(sd["moco.fc.weight"].numpy(), tree["moco"]["fc"]["kernel"].T)
    np.testing.assert_array_equal(sd["classifier.fc.weight"].numpy(),
                                  tree["classifier"]["fc"]["kernel"].T)
    back = to_jax_tree(_port(truncate))
    flat_a = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(tree)}
    flat_b = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(back)}
    assert set(flat_a) == set(flat_b)
    for k, v in flat_a.items():
        np.testing.assert_array_equal(flat_b[k], v, err_msg=k)


def test_bridge_refuses_a_tree_of_another_truncation():
    with pytest.raises(KeyError, match="weight bridge"):
        load_jax_tree(T.truncated_resnet50_init(None, 6, CLASSES, DIM, device="cpu"),
                      _jax_tree(5))


@pytest.mark.parametrize("truncate", [5, 6, 9])
def test_moco_and_combined_apply_match_jax_f32(truncate):
    tree = _jax_tree(truncate)
    x = _x()
    j_emb, _ = J.truncated_moco_apply(tree["moco"], jnp.asarray(x), truncate)
    j_logits, _ = J.combined_apply(tree["moco"], tree["classifier"], jnp.asarray(x), truncate)
    model = _port(truncate)
    with torch.inference_mode():
        emb = T.truncated_moco_apply(model.moco, torch.from_numpy(x), truncate)
        logits = T.combined_apply(model.moco, model.classifier, torch.from_numpy(x), truncate)
        assert torch.equal(model(torch.from_numpy(x)), logits)
    assert emb.shape == (2, DIM) and logits.shape == (2, CLASSES)
    np.testing.assert_allclose(emb.numpy(), np.asarray(j_emb), **F32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(j_logits), **F32)


@pytest.mark.parametrize("truncate", [5, 9])
def test_combined_apply_matches_jax_bf16(truncate):
    tree = _jax_tree(truncate)
    x = _x(2)
    j_logits, _ = J.combined_apply(tree["moco"], tree["classifier"],
                                   jnp.asarray(x).astype(jnp.bfloat16), truncate)
    model = _port(truncate)
    with torch.inference_mode():
        logits = T.combined_apply(model.moco, model.classifier,
                                  torch.from_numpy(x).to(torch.bfloat16), truncate)
    assert logits.dtype == torch.bfloat16
    np.testing.assert_allclose(logits.float().numpy(),
                               np.asarray(j_logits.astype(jnp.float32)), **BF16)


def test_encoder_truncate_9_is_the_pooled_layer4():
    model = _port(9)
    x = torch.from_numpy(_x())
    with torch.inference_mode():
        pooled, _ = resnet50_apply(model.moco.encoder, x, truncate=9)
        layer4, _ = resnet50_apply(model.moco.encoder, x, truncate=8)
    assert pooled.shape == (2, 2048)
    torch.testing.assert_close(pooled, layer4.mean(dim=(1, 2)))


def test_encoder_truncate_10_raises():
    """Truncate 10 runs the fc child, which only an encoder built at
    truncate 10 holds (``test_torch_remat.py`` holds that one against
    JAX); an encoder built at 9 refuses it."""
    enc = ResNet50Encoder(9)
    assert not hasattr(enc, "fc")
    with pytest.raises(ValueError, match="fc child"):
        resnet50_apply(enc, torch.zeros(1, 32, 32, 3), truncate=10)
