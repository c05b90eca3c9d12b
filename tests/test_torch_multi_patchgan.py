"""The port's family-3 model (``models/multi_patchgan.py`` and the ops
under it) against the JAX package on the same seeded numpy inputs and the
same weights (JAX init -> the weight bridge -> the port).

Size: ndf 8, gram dim 8, batch 2, 192² inputs. At ndf 8 the layer plan
gives the 150 patch six stride-2 convs, and the two stride-1 convs after
them need a 3x3 map, so 192² is the smallest input the default patch
sizes take.

Tolerances, each relative to the JAX result's own scale: the norms 1e-5
(f32 statistics in another order), the pool 1e-6, the Gram 1e-5 (one
rescale by L / (L + eps) after f32 sums); the model in f32 1e-4. In bf16
both sides round every stage's output to 8 bits, at other places (JAX
rounds its pooling and Gram products in bf16, the port sums them in f32
and rounds once): logits and Gram norms 2e-2 of max|ref|. The
embeddings, means of eight small attention outputs near bf16's
resolution, land about 2% (RMS, ‖Δ‖/‖ref‖) from the f32 result on either
side, and as far from each other: they are held within 5e-2 of max|ref|
of JAX's bf16 result, and the port's bf16 error against JAX's f32 result
to at most 1.5 times JAX's own bf16 error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.models import multi_patchgan as jmp
from heuristique_style_transfer_code_tpu.nn import patch_discriminator as jpd
from heuristique_style_transfer_code_tpu.ops import gram as jgram
from heuristique_style_transfer_code_tpu.ops import norm as jnorm
from heuristique_style_transfer_code_tpu.ops import pooling as jpool
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import (
    from_jax_tree,
    load_jax_tree,
    to_jax_tree,
)
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
    _flatten,
    load_pytree_npz,
    save_pytree_npz,
)
from heuristique_style_transfer_code_tpu_torch.config.schema import (
    MultiPatchGANConfig,
    load_config,
)
from heuristique_style_transfer_code_tpu_torch.models.multi_patchgan import (
    multiscale_test_apply,
    multiscale_test_init,
)
from heuristique_style_transfer_code_tpu_torch.nn import patch_discriminator as pd
from heuristique_style_transfer_code_tpu_torch.ops.gram import gram_matrix_ncl
from heuristique_style_transfer_code_tpu_torch.ops.norm import instance_norm, layer_norm_tail
from heuristique_style_transfer_code_tpu_torch.ops.pooling import adaptive_avg_pool2d

PATCH_SIZES = {"small": 10, "medium": 70, "large": 150}
NDF, GDIM, CLASSES, SIDE = 8, 8, 4, 192


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rms(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _jax_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=["batch", "instance"])
def family3(request):
    """(norm, JAX tree, port model with that tree's weights, input)."""
    norm = request.param
    tree = _jax_tree(jmp.multiscale_test_init(jax.random.PRNGKey(0), PATCH_SIZES, ndf=NDF,
                                              num_classes=CLASSES, gram_matrix_dim=GDIM,
                                              norm=norm))
    if norm == "batch":  # running statistics and affines that are not the identity
        rng = np.random.RandomState(1)
        for scale in PATCH_SIZES:
            for layer in tree[scale]["features"]:
                if layer["norm"] is not None:
                    c = layer["norm"]["scale"].shape[0]
                    layer["norm"] = {"scale": 1 + 0.2 * rng.randn(c).astype(np.float32),
                                     "bias": 0.2 * rng.randn(c).astype(np.float32),
                                     "mean": 0.1 * rng.randn(c).astype(np.float32),
                                     "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    model = multiscale_test_init(None, PATCH_SIZES, ndf=NDF, num_classes=CLASSES,
                                 gram_matrix_dim=GDIM, norm=norm, device="cpu")
    load_jax_tree(model, tree)
    x = np.random.RandomState(2).randn(2, SIDE, SIDE, 3).astype(np.float32)
    return norm, tree, model, x


def test_config_defaults_and_load_config(tmp_path):
    cfg = MultiPatchGANConfig()
    assert cfg.patch_sizes == PATCH_SIZES
    assert (cfg.num_classes, cfg.gram_matrix_dim, cfg.ndf, cfg.norm, cfg.batch_size) == (
        4, 64, 64, "batch", 32)
    path = tmp_path / "cfg.json"
    path.write_text('{"ndf": 8, "norm": "instance", "seed": 3, "classes": ["a"]}')
    got = load_config("multi_patchgan", str(path))
    assert (got.ndf, got.norm, got.seed, got.extra) == (8, "instance", 3, {"classes": ["a"]})


@pytest.mark.parametrize("patch,ndf", [(10, 64), (70, 64), (150, 64), (150, 8), (4, 16),
                                       (30, 32)])
def test_layer_plan_equals_jax(patch, ndf):
    assert pd.discriminator_layer_plan(patch, ndf) == jpd.discriminator_layer_plan(patch, ndf)


def test_default_config_runs_16_grams_and_13_norms():
    """The counts the card's launch checks rest on: convs (each with its
    projection and Gram) and norms of the three default discriminators."""
    convs = norms = 0
    for patch in PATCH_SIZES.values():
        strided, _, _ = pd.discriminator_layer_plan(patch, 64)
        convs += len(strided) + 2
        norms += len(strided) + 1
    assert (convs, norms) == (16, 13)


@pytest.mark.parametrize("shape", [(2, 13, 11, 24), (3, 5, 7, 1024), (1, 4, 4, 8)])
@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_matches_jax(shape, relu):
    x = (np.random.RandomState(3).randn(*shape) * 2 + 0.5).astype(np.float32)
    want = np.asarray(jnorm.instance_norm(jnp.asarray(x)))
    if relu:
        want = np.maximum(want, 0)
    got = instance_norm(torch.from_numpy(x), relu=relu)
    assert got.shape == shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("shape", [(2, 15, 13, 8), (2, 4, 4, 64), (1, 3)])
def test_layer_norm_tail_matches_jax(shape):
    x = (np.random.RandomState(4).randn(*shape) * 3 + 1).astype(np.float32)
    want = jnorm.layer_norm_tail(jnp.asarray(x))
    assert _rel(layer_norm_tail(torch.from_numpy(x)), want) <= 1e-5
    # NHWC and the reference's NCHW normalise the same set
    if len(shape) == 4:
        nchw = jnorm.layer_norm_tail(jnp.asarray(x.transpose(0, 3, 1, 2)))
        assert _rel(layer_norm_tail(torch.from_numpy(x)).permute(0, 3, 1, 2), nchw) <= 1e-5


@pytest.mark.parametrize("hw", [(15, 15), (13, 13), (54, 54), (2, 2), (12, 9)])
def test_adaptive_avg_pool2d_matches_jax(hw):
    x = np.random.RandomState(5).randn(2, *hw, 8).astype(np.float32)
    want = jpool.adaptive_avg_pool2d(jnp.asarray(x.transpose(0, 3, 1, 2)), 4)
    got = adaptive_avg_pool2d(torch.from_numpy(x), 4)
    assert got.shape == (2, 4, 4, 8)
    assert _rel(got.permute(0, 3, 1, 2), want) <= 1e-6


@pytest.mark.parametrize("c", [8, 64])
def test_family3_gram_matches_jax(c):
    """The discriminator's Gram of a pooled NHWC map: JAX's inline einsum
    and ``gram_matrix_ncl`` over (N, C, L) / (L + eps) against the port's
    ``gram_matrix_ncl`` on the transposed (N, L, C) view."""
    pooled = np.random.RandomState(6).randn(3, 4, 4, c).astype(np.float32)
    f_jax = jnp.asarray(pooled.transpose(0, 3, 1, 2).reshape(3, c, 16))
    want = jgram.gram_matrix_ncl(f_jax, 16 + pd.GRAM_EPS)
    inline = jnp.einsum("ncl,ndl->ncd", f_jax, f_jax,
                        preferred_element_type=jnp.float32) / (16 + pd.GRAM_EPS)
    f = torch.from_numpy(pooled).reshape(3, 16, c).transpose(1, 2)
    got = gram_matrix_ncl(f, 16 + pd.GRAM_EPS)
    assert got.shape == (3, c, c)
    assert _rel(got, want) <= 1e-5 and _rel(got, inline) <= 1e-5
    assert _rel(gram_matrix_ncl(f), jgram.gram_matrix_ncl(f_jax)) <= 1e-5


@pytest.mark.parametrize("norm", ["batch", "instance"])
def test_patch_discriminator_matches_jax(norm):
    tree = _jax_tree(jpd.patch_discriminator_test_init(
        jax.random.PRNGKey(1), 70, NDF, 3, CLASSES, GDIM, norm))
    model = pd.PatchDiscriminatorTest(70, NDF, 3, CLASSES, GDIM, norm).eval()
    load_jax_tree(model, tree)
    x = np.random.RandomState(7).randn(2, SIDE, SIDE, 3).astype(np.float32)
    je, jl, jn = jpd.patch_discriminator_test_apply(tree, jnp.asarray(x), GDIM, norm=norm)
    with torch.no_grad():
        e, logits, n = pd.patch_discriminator_test_apply(model, torch.from_numpy(x), GDIM, norm)
    assert e.shape == (2, NDF) and logits.shape == (2, CLASSES) and len(n) == len(jn) == 7
    assert _rel(e, je) <= 1e-4 and _rel(logits, jl) <= 1e-4
    assert max(_rel(a, b) for a, b in zip(n, jn)) <= 1e-4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_multiscale_test_apply_matches_jax(family3, dtype):
    norm, tree, model, x = family3
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    if dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    je, jl, jn = jmp.multiscale_test_apply(tree, jx, GDIM, norm=norm)
    with torch.no_grad():
        e, logits, n = multiscale_test_apply(model, tx, GDIM, norm)
    assert e.dtype == logits.dtype == n[0].dtype == tx.dtype
    assert e.shape == (2, NDF) and logits.shape == (2, CLASSES)
    assert len(n) == len(jn) == 19 and all(t.shape == (2,) for t in n)
    gram_norms = max(_rel(_np(a), _np(b)) for a, b in zip(n, jn))
    if dtype == "float32":
        assert _rel(e, je) <= 1e-4 and _rel(logits, jl) <= 1e-4 and gram_norms <= 1e-4
    else:
        assert _rel(_np(logits), _np(jl)) <= 2e-2 and gram_norms <= 2e-2
        assert _rel(_np(e), _np(je)) <= 5e-2
        je32 = _np(jmp.multiscale_test_apply(tree, jnp.asarray(x), GDIM, norm=norm)[0])
        assert _rms(_np(e), je32) <= 1.5 * _rms(_np(je), je32)


def test_bridge_round_trips_the_jax_tree(family3, tmp_path):
    """JAX tree -> port -> ``to_jax_tree`` gives back every leaf and every
    None norm; the npz the port writes reads back to the same model."""
    norm, tree, model, _ = family3
    back = to_jax_tree(model)
    want, got = _flatten(tree), _flatten(back)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert back["large"]["features"][-1]["norm"] is None
    assert (back["large"]["features"][0]["norm"] is None) == (norm == "instance")
    path = str(tmp_path / "f3.npz")
    save_pytree_npz(back, path)
    again = multiscale_test_init(None, PATCH_SIZES, ndf=NDF, num_classes=CLASSES,
                                 gram_matrix_dim=GDIM, norm=norm, device="cpu")
    load_jax_tree(again, load_pytree_npz(path))
    for (k, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b), k


def test_conv_weights_are_oihw_channels_last(family3):
    _, tree, model, _ = family3
    w = model.medium.features[1].conv.weight
    assert w.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(w.detach().numpy().transpose(2, 3, 1, 0),
                                  tree["medium"]["features"][1]["conv"]["kernel"])


def test_bridge_refuses_a_norm_mismatch():
    """A batch-norm tree into an instance-norm model (and back) fails on the
    leaves left over or missing, not silently."""
    tree = _jax_tree(jmp.multiscale_test_init(jax.random.PRNGKey(0), PATCH_SIZES, ndf=NDF,
                                              num_classes=CLASSES, gram_matrix_dim=GDIM,
                                              norm="batch"))
    inst = multiscale_test_init(None, PATCH_SIZES, ndf=NDF, num_classes=CLASSES,
                                gram_matrix_dim=GDIM, norm="instance", device="cpu")
    with pytest.raises(KeyError, match="left over"):
        load_jax_tree(inst, tree)
    batch = multiscale_test_init(None, PATCH_SIZES, ndf=NDF, num_classes=CLASSES,
                                 gram_matrix_dim=GDIM, norm="batch", device="cpu")
    with pytest.raises(KeyError, match="missing"):
        load_jax_tree(batch, to_jax_tree(inst))
    assert not any("norm" in k for k in from_jax_tree(to_jax_tree(inst)))
