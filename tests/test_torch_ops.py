"""Port ops against the JAX package's functions on the same numpy inputs
(CPU). Tolerances: f32 rtol/atol 1e-5 (same arithmetic, other summation
order); conv rtol/atol 1e-4 (a 7x7x3 or 3x3xC contraction summed in a
different order by XLA and by oneDNN)."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.ops import attention as jattn
from heuristique_style_transfer_code_tpu.ops import conv as jconv
from heuristique_style_transfer_code_tpu.ops.linear import linear as j_linear
from heuristique_style_transfer_code_tpu.ops import norm as jnorm
from heuristique_style_transfer_code_tpu.ops import pooling as jpool
from heuristique_style_transfer_code_tpu.ops import resize as jresize
from heuristique_style_transfer_code_tpu_torch.ops import attention as tattn
from heuristique_style_transfer_code_tpu_torch.ops import conv as tconv
from heuristique_style_transfer_code_tpu_torch.ops import linear as tlinear
from heuristique_style_transfer_code_tpu_torch.ops import norm as tnorm
from heuristique_style_transfer_code_tpu_torch.ops import pooling as tpool
from heuristique_style_transfer_code_tpu_torch.ops import resize as tresize

F32 = dict(rtol=1e-5, atol=1e-5)
CONV = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("k,stride,pad,cin,cout", [
    (7, 2, 3, 3, 16),   # the stem conv
    (3, 2, 1, 8, 8),    # a strided bottleneck conv2
    (1, 1, 0, 16, 32),  # a 1x1 expansion
])
def test_conv2d_matches_jax(k, stride, pad, cin, cout):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 17, 15, cin).astype(np.float32)
    kern = (rng.randn(k, k, cin, cout) * 0.2).astype(np.float32)
    want = np.asarray(jconv.conv2d({"kernel": jnp.asarray(kern)}, jnp.asarray(x), stride, pad))
    w = _t(tconv.hwio_to_oihw(kern)).contiguous(memory_format=torch.channels_last)
    got = tconv.conv2d(_t(x), w, stride, pad)
    assert got.is_contiguous()  # channels_last in, NHWC-contiguous out
    np.testing.assert_allclose(got.numpy(), want, **CONV)


def test_hwio_oihw_roundtrip():
    k = np.random.RandomState(1).randn(3, 5, 2, 4).astype(np.float32)
    np.testing.assert_array_equal(tconv.oihw_to_hwio(tconv.hwio_to_oihw(k)), k)


def test_max_pool2d_matches_jax():
    x = np.random.RandomState(2).randn(2, 11, 12, 5).astype(np.float32)
    want = np.asarray(jconv.max_pool2d(jnp.asarray(x), 3, 2, 1))
    got = tconv.max_pool2d(_t(x), 3, 2, 1)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_norm_eval_matches_jax(dtype):
    rng = np.random.RandomState(3)
    c = 6
    x = rng.randn(2, 4, 5, c).astype(np.float32) * 3 + 1
    p = {"scale": rng.rand(c).astype(np.float32) + 0.5, "bias": rng.randn(c).astype(np.float32),
         "mean": rng.randn(c).astype(np.float32), "var": rng.rand(c).astype(np.float32) + 0.1}
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jnorm.batch_norm({k: jnp.asarray(v) for k, v in p.items()}, jx)).astype(np.float32)
    tx = _t(x).to(getattr(torch, dtype))
    got = tnorm.batch_norm(tx, *(_t(p[k]) for k in ("scale", "bias", "mean", "var")))
    assert got.dtype == tx.dtype
    # bf16: one rounding of the output, 2^-8 relative
    tol = F32 if dtype == "float32" else dict(rtol=2 ** -8, atol=2 ** -8)
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


@pytest.mark.parametrize("c,s", [(64, 7), (256, 7), (2048, 7), (16, 4)])
def test_adaptive_pool_matrix_equal(c, s):
    got = tpool.adaptive_pool_matrix(c, s).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpool.adaptive_pool_matrix(c, s)))
    if c % s:  # overlapping bins: some channel feeds two bins
        assert ((got > 0).sum(axis=0) > 1).any()


def test_linear_matches_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(5, 16).astype(np.float32)
    k = rng.randn(16, 3).astype(np.float32)
    b = rng.randn(3).astype(np.float32)
    want = np.asarray(j_linear({"kernel": jnp.asarray(k), "bias": jnp.asarray(b)}, jnp.asarray(x)))
    got = tlinear.linear(_t(x), _t(k.T), _t(b))
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("heads", [1, 4])
def test_multihead_attention_matches_jax(heads):
    rng = np.random.RandomState(5)
    L, N, E = 4, 3, 16
    x = rng.randn(L, N, E).astype(np.float32)
    p = {"in_proj_weight": rng.randn(3 * E, E).astype(np.float32) * 0.3,
         "in_proj_bias": rng.randn(3 * E).astype(np.float32) * 0.1,
         "out_proj_weight": rng.randn(E, E).astype(np.float32) * 0.3,
         "out_proj_bias": rng.randn(E).astype(np.float32) * 0.1}
    want = np.asarray(jattn.multihead_attention({k: jnp.asarray(v) for k, v in p.items()},
                                                jnp.asarray(x), num_heads=heads))
    got = tattn.multihead_attention(_t(x), _t(p["in_proj_weight"]), _t(p["in_proj_bias"]),
                                    _t(p["out_proj_weight"]), _t(p["out_proj_bias"]), heads)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # and torch's own module, the semantics both claim
    mha = torch.nn.MultiheadAttention(E, heads)
    with torch.no_grad():
        mha.in_proj_weight.copy_(_t(p["in_proj_weight"]))
        mha.in_proj_bias.copy_(_t(p["in_proj_bias"]))
        mha.out_proj.weight.copy_(_t(p["out_proj_weight"]))
        mha.out_proj.bias.copy_(_t(p["out_proj_bias"]))
        ref, _ = mha(_t(x), _t(x), _t(x), need_weights=False)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), **F32)


def test_center_crop_normalize_and_eval_preprocess_match_jax():
    from heuristique_style_transfer_code_tpu.data.augment import eval_preprocess as j_eval
    from heuristique_style_transfer_code_tpu_torch.data.augment import eval_preprocess as t_eval

    rng = np.random.RandomState(6)
    img = rng.rand(2, 37, 41, 3).astype(np.float32)
    np.testing.assert_array_equal(tresize.center_crop(_t(img), 24).numpy(),
                                  np.asarray(jresize.center_crop(jnp.asarray(img), 24)))
    np.testing.assert_allclose(tresize.normalize_imagenet(_t(img)).numpy(),
                               np.asarray(jresize.normalize_imagenet(jnp.asarray(img))), **F32)
    u8 = rng.randint(0, 256, (2, 40, 40, 3)).astype(np.uint8)
    got = t_eval(_t(u8), crop=32)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(j_eval(jnp.asarray(u8), crop=32)), **F32)


def test_npz_reader_reads_jax_written_tree(tmp_path):
    from heuristique_style_transfer_code_tpu.checkpoint.io import save_pytree_npz as j_save
    from heuristique_style_transfer_code_tpu_torch.checkpoint.io import (
        load_pytree_npz,
        save_pytree_npz,
    )

    rng = np.random.RandomState(7)
    w = rng.randn(3, 4).astype(np.float32)
    half = rng.randn(5).astype(np.float32)
    tree = {"a": {"w": jnp.asarray(w), "none": None, "empty": {}},
            "layers": [{"k": jnp.asarray(half, jnp.bfloat16)}, {"k": jnp.arange(3)}],
            "nothing": []}
    path = str(tmp_path / "t.npz")
    j_save(tree, path)
    got = load_pytree_npz(path)
    np.testing.assert_array_equal(got["a"]["w"], w)
    assert got["a"]["none"] is None and got["a"]["empty"] == {} and got["nothing"] == []
    bf = got["layers"][0]["k"]
    assert bf.dtype == np.float32  # V2 bit patterns widened exactly
    np.testing.assert_array_equal(bf, np.asarray(jnp.asarray(half, jnp.bfloat16), np.float32))
    np.testing.assert_array_equal(got["layers"][1]["k"], np.arange(3))
    # and the port's writer round-trips its own reader
    save_pytree_npz(got, str(tmp_path / "u.npz"))
    again = load_pytree_npz(str(tmp_path / "u.npz"))
    np.testing.assert_array_equal(again["layers"][0]["k"], bf)
    assert again["a"]["none"] is None and again["nothing"] == []


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_weighted_prf_matches_sklearn(seed):
    from sklearn.metrics import f1_score, precision_score, recall_score

    from heuristique_style_transfer_code_tpu_torch.metrics.classification import (
        weighted_precision_recall_f1,
    )

    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 4, 30).tolist()
    preds = rng.randint(0, 5 if seed == 2 else 3, 30).tolist()  # unseen and missing classes
    got = weighted_precision_recall_f1(labels, preds)
    want = {
        "precision": precision_score(labels, preds, average="weighted", zero_division=0),
        "recall": recall_score(labels, preds, average="weighted", zero_division=0),
        "f1_score": f1_score(labels, preds, average="weighted", zero_division=0),
    }
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-15)
    json.dumps(got)  # plain floats


def test_png_writer_reads_back_with_pil(tmp_path):
    from PIL import Image

    from heuristique_style_transfer_code_tpu_torch.utils.png import float_to_uint8, write_png

    rgb = np.random.RandomState(8).randint(0, 256, (9, 13, 3)).astype(np.uint8)
    path = str(tmp_path / "sub" / "x.png")
    write_png(path, rgb)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), rgb)
    np.testing.assert_array_equal(float_to_uint8(np.array([0.0, 0.5, 1.0, 1.5])), [0, 127, 255, 255])
