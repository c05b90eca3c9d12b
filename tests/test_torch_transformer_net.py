"""The port's fast-style net (``nn/transformer_net.py``), its weight bridge,
its conv with bias and the serving program of ``tasks/fast_style.py``
against the JAX package, on nets the JAX package initialised (width 4,
n_res 2, 16-32 px).

Tolerances: net outputs atol 1e-4 in the normalised space (f32, the same
arithmetic in another order through 15 norms); bf16 within 0.05 of f32 in
[0, 1] space, the JAX package's own bound (tests/test_fast_style.py);
uint8 output within 1 step at every pixel, at least 99% equal (a value
that lands within rounding of a half step may round either way)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.nn import transformer_net as jt
from heuristique_style_transfer_code_tpu.ops.conv import conv2d as j_conv2d
from heuristique_style_transfer_code_tpu.ops.resize import IMAGENET_MEAN, IMAGENET_STD
from heuristique_style_transfer_code_tpu.tasks import fast_style as jf
from heuristique_style_transfer_code_tpu_torch.checkpoint.convert import to_jax_tree
from heuristique_style_transfer_code_tpu_torch.nn import transformer_net as pt
from heuristique_style_transfer_code_tpu_torch.ops.conv import conv2d, hwio_to_oihw
from heuristique_style_transfer_code_tpu_torch.tasks import fast_style as pf


def _np_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _cond_tree(n_styles=3, seed=0):
    """A conditional JAX net whose per-style tables differ (init gives ones
    and zeros for every style)."""
    tree = _np_tree(jt.transformer_net_init(jax.random.PRNGKey(seed), width=4, n_res=2,
                                            n_styles=n_styles))
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


def _images(b=2, size=16, seed=1):
    return np.random.RandomState(seed).randn(b, size, size, 3).astype(np.float32)


def _port_apply(net, x, **kw):
    with torch.inference_mode():
        return pt.transformer_net_apply(net, torch.tensor(x), **kw).numpy()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv2d_bias_matches_jax(dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 9, 7, 5).astype(np.float32)
    k = rng.randn(3, 3, 5, 6).astype(np.float32)
    bias = rng.randn(6).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(j_conv2d({"kernel": jnp.asarray(k), "bias": jnp.asarray(bias)},
                               jnp.asarray(x, jd), stride=2, padding=1).astype(jnp.float32))
    got = conv2d(torch.tensor(x).to(dtype), torch.tensor(hwio_to_oihw(k)), 2, 1,
                 torch.tensor(bias))
    assert got.dtype == dtype
    # bf16: JAX adds the f32 bias before its one rounding, the port inside the conv
    tol = 1e-5 if dtype == torch.float32 else 0.05 * np.abs(want).max()
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-5, atol=tol)


def test_single_style_net_matches_jax():
    params = jt.transformer_net_init(jax.random.PRNGKey(0), width=4, n_res=2)
    net = pf.net_from_tree(_np_tree(params), "cpu")
    x = _images()
    want = np.asarray(jt.transformer_net_apply(params, jnp.asarray(x)))
    np.testing.assert_allclose(_port_apply(net, x), want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("rows", ["one_hot", "blended"])
def test_conditional_net_matches_jax(rows):
    tree = _cond_tree()
    net = pf.net_from_tree(tree, "cpu")
    assert pt.net_n_styles(net) == jt.net_n_styles(tree) == 3
    w = (np.eye(3, dtype=np.float32)[[2, 0]] if rows == "one_hot"
         else np.array([[0.2, 0.5, 0.3], [0.6, 0.0, 0.4]], np.float32))
    x = _images()
    want = np.asarray(jt.transformer_net_apply(tree, jnp.asarray(x),
                                               style_weights=jnp.asarray(w)))
    np.testing.assert_allclose(_port_apply(net, x, style_weights=torch.tensor(w)), want,
                               rtol=0, atol=1e-4)


def test_select_style_matches_jax():
    tree = _cond_tree()
    x = _images()
    for s in range(3):
        sliced = pt.select_style(pf.net_from_tree(tree, "cpu"), s)
        assert pt.net_n_styles(sliced) is None
        want = np.asarray(jt.transformer_net_apply(jt.select_style(tree, s), jnp.asarray(x)))
        np.testing.assert_allclose(_port_apply(sliced, x), want, rtol=0, atol=1e-4)


def test_bridge_round_trips_conditional_tables_untransposed():
    tree = _cond_tree(n_styles=3)
    back = to_jax_tree(pf.net_from_tree(tree, "cpu"))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for got, want in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    assert back["res"][1]["in_b"]["scale"].shape == (3, 16)


def test_count_params_classic_config_equals_jax():
    params = jt.transformer_net_init(jax.random.PRNGKey(0))
    net = pt.transformer_net_init(torch.Generator().manual_seed(0), device="cpu")
    assert pt.count_params(net) == jt.count_params(params)
    assert 1.5e6 < pt.count_params(net) < 2.0e6


def test_bf16_close_to_f32():
    net = pf.net_from_tree(_np_tree(jt.transformer_net_init(jax.random.PRNGKey(0), width=4,
                                                            n_res=1)), "cpu")
    x = _images(1)
    a = _port_apply(net, x) * IMAGENET_STD + IMAGENET_MEAN
    b = _port_apply(net, x, compute_dtype=torch.bfloat16) * IMAGENET_STD + IMAGENET_MEAN
    assert np.abs(a - b).max() < 0.05


def _u8_close(got, want):
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


def test_make_stylize_fn_matches_jax():
    params = jt.transformer_net_init(jax.random.PRNGKey(0), width=4, n_res=2)
    net = pf.net_from_tree(_np_tree(params), "cpu")
    u8 = np.random.RandomState(2).randint(0, 256, (3, 36, 36, 3)).astype(np.uint8)
    want = np.asarray(jf.make_stylize_fn(params, crop=32)(jnp.asarray(u8)))
    got = pf.make_stylize_fn(net, crop=32)(u8)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (3, 32, 32, 3)
    _u8_close(got.numpy(), want)


def test_net_job_fn_matches_jax_on_conditional_rows():
    tree = _cond_tree()
    net = pf.net_from_tree(tree, "cpu")
    u8 = np.random.RandomState(3).randint(0, 256, (2, 16, 16, 3)).astype(np.uint8)
    w = np.array([[1.0, 0.0, 0.0], [0.25, 0.25, 0.5]], np.float32)
    ids = np.arange(2, dtype=np.int32)
    want, _, _ = jf.make_net_job_fn(tree, crop=16)(jnp.asarray(u8), jnp.asarray(w), ids)
    got, iters, per = pf.make_net_job_fn(net, crop=16)(u8, w, ids)
    _u8_close(got.numpy(), np.asarray(want))
    assert iters == 1 and per.tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="gallery width"):
        pf.make_net_job_fn(net, crop=16)(u8, w[:, :2], ids)


@pytest.mark.parametrize("name", ["make_fast_style_train_step", "train_fast_style",
                                  "train_multi_style"])
def test_training_is_not_ported_yet(name, tmp_path):
    """Training is ported, and so is its data-parallel path (``mesh=``;
    two ranks in tests/test_torch_data_parallel.py): the mesh of a one-rank
    gloo group runs that path (the gradients' all-reduce, the global mean
    loss) and gives the numbers of ``mesh=None`` within f32 rounding."""
    import torch.distributed as dist

    from heuristique_style_transfer_code_tpu_torch.core.mesh import create_mesh, data_parallel
    from heuristique_style_transfer_code_tpu_torch.ops.gram import gram_matrix_nhwc
    from heuristique_style_transfer_code_tpu_torch.parallel.multihost import (
        initialize_distributed,
        shutdown_distributed,
    )

    def extract(images):
        return images, [gram_matrix_nhwc(images)]

    u8 = np.random.RandomState(3).randint(0, 256, (2, 20, 20, 3)).astype(np.uint8)
    styles = [np.random.RandomState(4 + k).randint(0, 256, (24, 24, 3)).astype(np.uint8)
              for k in range(2)]

    def run(mesh):
        if name == "train_multi_style":
            net = pf.net_from_tree(_cond_tree(2), "cpu")
        else:
            net = pt.transformer_net_init(torch.Generator().manual_seed(0), width=4, n_res=1,
                                          device="cpu")
        if name == "make_fast_style_train_step":
            init, step = pf.make_fast_style_train_step(extract, crop=16, mesh=mesh)
            grams = pf.encode_style_grams(extract, styles[0], 16, "cpu")
            net, _, loss = step(net, init(net), u8, grams)
            history = [float(loss)]
        elif name == "train_fast_style":
            net, history = pf.train_fast_style(net, extract, [{"image": u8}], styles[0],
                                               epochs=1, crop=16, mesh=mesh,
                                               log_fn=lambda s: None, log_every=1)
        else:
            net, history = pf.train_multi_style(net, extract, [{"image": u8}], styles,
                                                epochs=1, crop=16, mesh=mesh,
                                                log_fn=lambda s: None, log_every=1)
        return history, {k: v.detach().clone() for k, v in net.state_dict().items()}

    h0, p0 = run(None)
    assert not dist.is_initialized()
    initialize_distributed(0, 1, "file://" + str(tmp_path / "rendezvous"), backend="gloo")
    try:
        mesh = create_mesh(1)
        assert data_parallel(mesh) is mesh and mesh.backend == "gloo"
        h1, p1 = run(mesh)
    finally:
        shutdown_distributed()
    np.testing.assert_allclose(h1, h0, rtol=1e-6)
    assert np.isfinite(h0).all()
    for k in p0:
        np.testing.assert_allclose(p1[k].numpy(), p0[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
