"""``--precision int8``: the port's ``nn/resnet_int8.py`` and the int8
forwards of families 1 and 2 against the JAX package's, on the CPU.

- ``fold_conv_bn`` and ``_quantize_kernel`` bit-equal to JAX's;
- ``calibrate_activation_scales`` within 1e-5 relative of JAX's on the
  same weights and batches (f32 convolutions summed in other orders);
- on the same quantised tree (JAX's, through its npz file): the input's
  and the stem's int8 maps bit for bit, every later int8 map within one
  step on at most 0.1 % of its elements (an f32 epilogue that lands on a
  rounding tie in one package and not the other), the features within
  2·s_out of the last block;
- family 1's int8 logits within 1e-3 of JAX's int8 ones, argmax equal;
  family 2's int8 pooled Grams within 1e-4 relative of the largest entry
  and its logits within 1e-3;
- a ``q.npz`` crosses between the packages both ways, leaf for leaf;
- JAX's own contracts hold on the port's PTQ (its calibration and
  quantisation): feature cosine > 0.99 against f32 at every image,
  logits within 0.15 of f32 with the argmax agreeing on at least 3/4;
  family 2's embeddings cosine > 0.98 and logits within 0.2;
- the plain int8 GEMM (float64) is exact, inputs out of the calibrated
  range stay finite, and a truncation outside [4, 8] raises;
- the calibration source (``make_calibration_loader``) picks JAX's
  samples in JAX's order, with its warning and errors.

Sizes: truncate 5 and 6, dim 16, 4 classes, b4 at 64 px (family 2: S 4),
batch-norm parameters and statistics randomised so that the folds do
real work."""
import argparse
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import load_jax_tree, to_jax_tree
from heuristique_style_transfer_code_tpu_torch.checkpoint.io import _flatten, load_pytree_npz
from heuristique_style_transfer_code_tpu_torch.nn import resnet_int8 as pq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small shapes: one intra-op thread keeps the test workers that share
    the host from oversubscribing it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomise_bn(tree, rng):
    """Every batch norm of a JAX-layout tree with random scale, bias and
    statistics."""
    if isinstance(tree, dict):
        if set(tree) >= {"scale", "bias", "mean", "var"}:
            c = np.shape(tree["scale"])[0]
            return {"scale": (rng.rand(c) + 0.5).astype(np.float32),
                    "bias": (rng.randn(c) * 0.1).astype(np.float32),
                    "mean": (rng.randn(c) * 0.1).astype(np.float32),
                    "var": (rng.rand(c) + 0.5).astype(np.float32)}
        return {k: _randomise_bn(v, rng) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_randomise_bn(v, rng) for v in tree]
    return tree


def _family1(truncate, seed=0):
    """(port model, its JAX-layout tree) of family 1 at ``truncate``, dim
    16, 4 classes, with random batch norms."""
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        truncated_resnet50_init,
    )

    model = truncated_resnet50_init(torch.Generator().manual_seed(seed), truncate, 4, 16,
                                    device="cpu")
    tree = _randomise_bn(to_jax_tree(model), np.random.RandomState(seed + 1))
    return load_jax_tree(model, tree), tree


def _batches(seed=1, n=2, b=4, hw=64):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, hw, hw, 3).astype(np.float32) for _ in range(n)]


def _jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def test_fold_and_weight_quantisation_are_bit_equal_to_jax():
    from heuristique_style_transfer_code_tpu.nn import resnet_int8 as jq

    rng = np.random.RandomState(0)
    conv = {"kernel": rng.randn(3, 3, 8, 16).astype(np.float32) * 0.1}
    bn = {"scale": rng.rand(16).astype(np.float32) + 0.5, "bias": rng.randn(16).astype(np.float32),
          "mean": rng.randn(16).astype(np.float32), "var": rng.rand(16).astype(np.float32) + .2}
    conv["kernel"][..., 3] = 0.0  # a dead channel: scale 1, all zeros
    for got, want in zip(pq.fold_conv_bn(conv, bn), jq.fold_conv_bn(conv, bn)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    k, _ = pq.fold_conv_bn(conv, bn)
    for got, want in zip(pq._quantize_kernel(k), jq._quantize_kernel(k)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("truncate", [5, 6])
def test_calibration_matches_jax(truncate):
    from heuristique_style_transfer_code_tpu.nn.resnet_int8 import calibrate_activation_scales

    model, tree = _family1(truncate)
    batches = _batches()
    want = calibrate_activation_scales(_jax(tree["moco"]["encoder"]), batches, truncate)
    got = pq.calibrate_activation_scales(model.moco.encoder,
                                         [torch.from_numpy(x) for x in batches], truncate)
    assert got.keys() == want.keys()
    flat_got, flat_want = _flatten(got), _flatten(want)
    assert flat_got.keys() == flat_want.keys()
    for key in flat_want:
        np.testing.assert_allclose(flat_got[key], flat_want[key], rtol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def shared_tree(tmp_path_factory):
    """JAX's quantised encoder (truncate 6), written by its
    ``save_quantized``, and each side's copy: (port model, JAX tree,
    JAX q, port q, the calibration batches)."""
    from heuristique_style_transfer_code_tpu.nn import resnet_int8 as jq

    model, tree = _family1(6, seed=3)
    batches = _batches(seed=4)
    j_q = jq.prepare_int8_resnet(_jax(tree["moco"]["encoder"]), batches, 6)
    path = str(tmp_path_factory.mktemp("q") / "q.npz")
    jq.save_quantized(j_q, path)
    return model, tree, jq.load_quantized(path), pq.load_quantized(path, device="cpu"), batches


def _recorded_maps(module, apply, q, x):
    """Every int8 map ``apply(q, x)`` requantises, in order, through the
    module's ``_requant``."""
    maps, real = [], module._requant

    def recording(y, s):
        out = real(y, s)
        maps.append(np.asarray(out))
        return out

    module._requant = recording
    try:
        feats = apply(q, x)
    finally:
        module._requant = real
    return maps, np.asarray(feats)


def test_int8_maps_and_features_match_jax_on_the_same_tree(shared_tree):
    from heuristique_style_transfer_code_tpu.nn import resnet_int8 as jq

    _, _, j_q, p_q, _ = shared_tree
    x = np.random.RandomState(5).randn(4, 64, 64, 3).astype(np.float32)
    j_maps, j_feats = _recorded_maps(jq, jq.resnet50_apply_int8, j_q, jnp.asarray(x))
    p_maps, p_feats = _recorded_maps(pq, pq.resnet50_apply_int8, p_q, torch.from_numpy(x))
    # input, stem, then (h1, h2, out) for each of layer1's 3 and layer2's 4 blocks
    assert len(p_maps) == len(j_maps) == 2 + 3 * 7
    for i, (a, b) in enumerate(zip(p_maps, j_maps)):
        assert a.dtype == b.dtype == np.int8 and a.shape == b.shape, i
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        if i < 2:
            assert not diff.any(), i
        else:
            assert diff.max() <= 1 and np.mean(diff > 0) <= 1e-3, (i, np.mean(diff > 0))
    s_out = j_q["layer2"][-1]["s_out"]
    assert np.abs(p_feats - j_feats).max() <= 2 * s_out


def test_family1_int8_logits_match_jax(shared_tree):
    from heuristique_style_transfer_code_tpu.models.truncated_resnet50 import (
        combined_apply_int8 as j_apply,
    )
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply_int8,
    )

    model, tree, j_q, p_q, _ = shared_tree
    x = np.random.RandomState(6).randn(8, 64, 64, 3).astype(np.float32)
    want, _ = j_apply(j_q, _jax(tree["moco"]), _jax(tree["classifier"]), jnp.asarray(x))
    got = combined_apply_int8(p_q, model.moco, model.classifier, torch.from_numpy(x))
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-3)
    assert np.array_equal(got.argmax(1).numpy(), want.argmax(1))


def test_family2_int8_grams_and_logits_match_jax(tmp_path):
    from heuristique_style_transfer_code_tpu.models import gram_attention as jg
    from heuristique_style_transfer_code_tpu.nn import resnet_int8 as jq
    from heuristique_style_transfer_code_tpu_torch.models import gram_attention as pg

    t, s = 6, 4
    model = pg.gram_attention_init(torch.Generator().manual_seed(7), t, 4, s, device="cpu")
    tree = _randomise_bn(to_jax_tree(model), np.random.RandomState(8))
    load_jax_tree(model, tree)
    batches = _batches(seed=9)
    j_q = jg.prepare_gram_attention_int8(_jax(tree), t, batches)
    jq.save_quantized(j_q, str(tmp_path / "q.npz"))
    p_q = pq.load_quantized(str(tmp_path / "q.npz"), device="cpu")
    x = np.random.RandomState(10).randn(4, 64, 64, 3).astype(np.float32)
    _, j_grams = jq.resnet50_apply_int8(j_q, jnp.asarray(x), collect_grams=True,
                                        gram_pool_size=s)
    _, p_grams = pq.resnet50_apply_int8(p_q, torch.from_numpy(x), collect_grams=True,
                                        gram_pool_size=s)
    assert len(p_grams) == len(j_grams) == 2
    for got, want in zip(p_grams, j_grams):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    j_emb, j_logits, _ = jg.gram_attention_apply_int8(j_q, _jax(tree), jnp.asarray(x), s, 4)
    emb, logits = pg.gram_attention_apply_int8(p_q, model, torch.from_numpy(x), s, 4)
    np.testing.assert_allclose(emb.detach().numpy(), np.asarray(j_emb), rtol=0, atol=1e-3)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(j_logits), rtol=0, atol=1e-3)


def test_quantized_npz_crosses_between_packages_both_ways(shared_tree, tmp_path):
    from heuristique_style_transfer_code_tpu.nn import resnet_int8 as jq

    _, _, j_q, p_q, _ = shared_tree
    pq.save_quantized(p_q, str(tmp_path / "port.npz"))
    back = jq.load_quantized(str(tmp_path / "port.npz"))
    a = _flatten(jax.tree_util.tree_map(np.asarray, back))
    b = _flatten(jax.tree_util.tree_map(np.asarray, j_q))
    assert a.keys() == b.keys()
    for key in b:
        assert np.asarray(a[key]).dtype == np.asarray(b[key]).dtype, key
        assert np.array_equal(a[key], b[key]), key
    raw = load_pytree_npz(str(tmp_path / "port.npz"))
    assert raw["stem"]["w"].dtype == np.int8 and raw["stem"]["w"].shape == (7, 7, 3, 64)
    assert isinstance(p_q["s_input"], float) and isinstance(p_q["truncate"], int)
    assert p_q["truncate"] == 6 and p_q["stem"]["w"].dtype == torch.int8


@pytest.mark.parametrize("truncate", [5, 6])
def test_jax_contracts_hold_on_the_port_ptq(truncate):
    from heuristique_style_transfer_code_tpu_torch.models.truncated_resnet50 import (
        combined_apply,
        combined_apply_int8,
        prepare_combined_int8,
    )
    from heuristique_style_transfer_code_tpu_torch.nn.resnet import resnet50_apply

    model, _ = _family1(truncate, seed=11)
    batches = [torch.from_numpy(b) for b in _batches(seed=12)]
    q = prepare_combined_int8(model.moco, truncate, batches)
    x = batches[0]
    with torch.no_grad():
        f32, _ = resnet50_apply(model.moco.encoder, x, truncate)
        i8 = pq.resnet50_apply_int8(q, x)
        a, b = f32.reshape(4, -1).numpy(), i8.reshape(4, -1).numpy()
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
        assert cos.min() > 0.99, cos
        xs = torch.from_numpy(np.random.RandomState(13).randn(16, 64, 64, 3).astype(np.float32))
        want = combined_apply(model.moco, model.classifier, xs, truncate)
        got = combined_apply_int8(q, model.moco, model.classifier, xs)
    assert (got.argmax(1) == want.argmax(1)).float().mean() >= 0.75
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=0.15)
    wild = torch.from_numpy(np.random.RandomState(14).randn(2, 64, 64, 3).astype(np.float32) * 3)
    assert torch.isfinite(pq.resnet50_apply_int8(q, wild)).all()


def test_family2_port_ptq_keeps_the_jax_contract():
    from heuristique_style_transfer_code_tpu_torch.models import gram_attention as pg

    t, s = 5, 4
    model = pg.gram_attention_init(torch.Generator().manual_seed(2), t, 4, s, device="cpu")
    batches = [torch.from_numpy(b) for b in _batches(seed=5)]
    q = pg.prepare_gram_attention_int8(model, t, batches)
    with torch.no_grad():
        emb_f, log_f = pg.gram_attention_apply(model, batches[0], t, s, 4)
        emb_q, log_q = pg.gram_attention_apply_int8(q, model, batches[0], s, 4)
    a, b = emb_f.numpy(), emb_q.numpy()
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1) + 1e-12)
    assert cos.min() > 0.98, cos
    np.testing.assert_allclose(log_q.numpy(), log_f.numpy(), atol=0.2)


def test_plain_int8_gemm_is_exact_and_truncation_is_bounded():
    rng = np.random.RandomState(15)
    a = rng.randint(-127, 128, (37, 4608)).astype(np.int8)
    b = rng.randint(-127, 128, (4608, 24)).astype(np.int8)
    got = pq.int8_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), a.astype(np.int64) @ b.astype(np.int64))
    model, _ = _family1(5)
    for truncate in (3, 9):
        with pytest.raises(ValueError, match=r"truncate in \[4, 8\]"):
            pq.quantize_resnet50(model.moco.encoder, {"input": 1.0, "stem": 1.0}, truncate,
                                 device="cpu")


def _ns(**kw):
    base = {"calib_data": None, "data": None}
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("case", ["train_split", "calib_override", "test_fallback", "none"])
def test_calibration_source_matches_jax(tiny_imagefolder, tmp_path, capsys, case):
    from heuristique_style_transfer_code_tpu.cli._common import (
        make_calibration_loader as j_loader,
    )
    from heuristique_style_transfer_code_tpu_torch.cli._common import make_calibration_loader

    if case == "none":
        with pytest.raises(ValueError, match="calib") as got:
            make_calibration_loader(_ns(), 4)
        with pytest.raises(ValueError) as want:
            j_loader(_ns(), 4)
        assert str(got.value) == str(want.value)
        return
    args = _ns(data=str(tiny_imagefolder))
    if case != "train_split":
        root = tmp_path / "testonly"
        shutil.copytree(str(tiny_imagefolder / "test"), str(root / "test"))
        args = (_ns(calib_data=str(root), data=str(tiny_imagefolder)) if case == "calib_override"
                else _ns(data=str(root)))
    got = make_calibration_loader(args, 48)
    got_out = capsys.readouterr().out
    want = j_loader(args, 48)
    assert got.samples == want.samples and got.batch_size == want.batch_size == 32
    assert got_out == capsys.readouterr().out
    assert ("Avertissement" in got_out) == (case == "test_fallback")
    first = next(iter(make_calibration_loader(args, 4)))
    assert set(first["label"][: first["n_valid"]].tolist()) == {0, 1, 2, 3}
