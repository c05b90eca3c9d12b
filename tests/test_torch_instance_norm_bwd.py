"""K3's backward in the port (``ops/kernels/instance_norm.py``:
``instance_norm_bwd_plain``, which the CPU runs and the card's
``instance_norm_bwd`` kernel is held against, and ``InstanceNormFunction``)
against ``jax.vjp`` of the JAX package's compositions: ``ops/norm.py``'s
``instance_norm`` followed by a ReLU (family 3's norm) and
``nn/transformer_net._in_apply`` with per-image affine rows that differ
(the fast-style net's, which training will differentiate).

Tolerances, each relative to the JAX result's own scale (max and RMS):
f32 1e-5 (the same f32 arithmetic in another order; dx cancels three terms
of the size of g); bf16 2e-2 (dx rounds once to bf16 on both sides, 2^-8,
from f32 sums that agree to 1e-6); dscale and dbias stay f32 in both
packages, so 1e-5 in f32 and, from bf16 inputs, 1e-4 (the same bf16
values summed in another order). ``gradcheck`` in f64 at its defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from heuristique_style_transfer_code_tpu.nn.transformer_net import _in_apply as j_in_apply
from heuristique_style_transfer_code_tpu.ops import norm as jnorm
from heuristique_style_transfer_code_tpu_torch.ops import norm as pnorm
from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TOL_AFFINE = {"float32": 1e-5, "bfloat16": 1e-4}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _errs(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    diff = got - want
    return (float(np.abs(diff).max() / np.abs(want).max()),
            float(np.linalg.norm(diff) / np.linalg.norm(want)))


def _inputs(shape, seed):
    """Signed x like conv outputs with per-channel offsets, a cotangent,
    and per-image affine rows that differ."""
    rng = np.random.RandomState(seed)
    b, c = shape[0], shape[-1]
    x = (rng.randn(*shape) * 2 + 0.5 + rng.randn(c)).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    scale = rng.randn(b, c).astype(np.float32)
    bias = rng.randn(b, c).astype(np.float32)
    return x, dy, scale, bias


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("relu", [False, True])
def test_gradcheck_f64(relu):
    rng = np.random.RandomState(0)
    x = torch.tensor(rng.randn(2, 13, 5) * 2 + 1, dtype=torch.float64, requires_grad=True)
    s = torch.tensor(rng.randn(2, 5), dtype=torch.float64, requires_grad=True)
    b = torch.tensor(rng.randn(2, 5), dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda x, s, b: kin.InstanceNormFunction.apply(x, s, b, kin.EPS, relu), (x, s, b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 9, 7, 16), (1, 13, 13, 40)])
def test_family3_norm_grad_matches_jax(shape, dtype):
    """dx of the port's ``ops/norm.instance_norm(x, relu=True)`` (the
    family-3 discriminator's norm) through autograd against jax.vjp of
    ReLU(JAX ``instance_norm``)."""
    tdt, jdt = DTYPES[dtype]
    x, dy, _, _ = _inputs(shape, 1)
    _, vjp = jax.vjp(lambda v: jnp.maximum(jnorm.instance_norm(v), 0),
                     jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(dy, jdt))
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    y = pnorm.instance_norm(xt, relu=True)
    (got,) = torch.autograd.grad(y, xt, torch.tensor(dy).to(tdt))
    assert got.dtype == tdt
    errs = _errs(_np(got), _np(want))
    assert max(errs) <= TOL[dtype], errs


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_affine_grads_match_jax_in_apply(dtype, relu):
    """dx, dscale and dbias of ``InstanceNormFunction`` with per-image rows
    against jax.vjp of ``_in_apply`` given a (B, C) table and one-hot style
    weights (each image's row is exactly its table row, so the table's
    gradient is the per-image rows')."""
    tdt, jdt = DTYPES[dtype]
    shape = (3, 11, 9, 24)
    x, dy, scale, bias = _inputs(shape, 2)
    b, h, w, c = shape

    def f(v, s, t):
        return j_in_apply({"scale": s, "bias": t}, v, jnp.eye(b, dtype=jnp.float32), relu=relu,
                          backend="xla")

    _, vjp = jax.vjp(f, jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    want = vjp(jnp.asarray(dy, jdt))
    xt = torch.tensor(x).to(tdt).reshape(b, h * w, c).requires_grad_(True)
    st = torch.tensor(scale).requires_grad_(True)
    bt = torch.tensor(bias).requires_grad_(True)
    y = kin.InstanceNormFunction.apply(xt, st, bt, kin.EPS, relu)
    got = torch.autograd.grad(y, (xt, st, bt), torch.tensor(dy).to(tdt).reshape(b, h * w, c))
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    for name, g, wnt, tol in (("dx", got[0].reshape(shape), want[0], TOL[dtype]),
                              ("dscale", got[1], want[1], TOL_AFFINE[dtype]),
                              ("dbias", got[2], want[2], TOL_AFFINE[dtype])):
        errs = _errs(_np(g), _np(wnt))
        assert max(errs) <= tol, (name, errs)


def test_mask_comes_from_the_forward_output():
    """Under ReLU the backward takes its mask from y where given: a unit
    that y says was off passes no gradient, whatever x recomputes to."""
    x, dy, scale, bias = _inputs((1, 6, 5, 8), 3)
    xt = torch.tensor(x).reshape(1, 30, 8)
    st, bt, dyt = torch.tensor(scale), torch.tensor(bias), torch.tensor(dy).reshape(1, 30, 8)
    y = kin.instance_norm_fwd_plain(xt, st, bt, relu=True)
    on = kin.instance_norm_bwd_plain(xt, dyt, st, bt, relu=True, y=y)
    mine = kin.instance_norm_bwd_plain(xt, dyt, st, bt, relu=True)
    for a, b_ in zip(on, mine):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    off = kin.instance_norm_bwd_plain(xt, dyt, st, bt, relu=True, y=torch.zeros_like(y))
    assert float(off[2].abs().max()) == 0.0 and float(off[1].abs().max()) == 0.0
    assert float(off[0].abs().max()) == 0.0


@pytest.mark.parametrize("relu", [False, True])
def test_wrapper_on_the_cpu_is_the_plain_version(relu):
    x, dy, scale, bias = _inputs((2, 7, 7, 12), 4)
    args = (torch.tensor(x).reshape(2, 49, 12), torch.tensor(dy).reshape(2, 49, 12),
            torch.tensor(scale), torch.tensor(bias))
    before = dict(kin.LAUNCHES)
    for a, b_ in zip(kin.instance_norm_bwd(*args, relu=relu),
                     kin.instance_norm_bwd_plain(*args, relu=relu)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
    assert kin.LAUNCHES == before  # the CPU launches no kernel, so counts none


def test_norm_first_run_in_inference_mode_still_differentiates():
    """``ops/norm.instance_norm`` caches its unit scale and bias per shape.
    Evaluation and the camera run under ``torch.inference_mode``; a style
    loop at the same shape later in the same process saves those tensors
    for its backward, so they must not be inference tensors."""
    pnorm._unit_affine.cache_clear()
    x = torch.tensor(np.random.RandomState(9).randn(1, 6, 6, 8).astype(np.float32))
    with torch.inference_mode():
        y_eval = pnorm.instance_norm(x, relu=True)
    xg = x.clone().requires_grad_(True)
    y = pnorm.instance_norm(xg, relu=True)
    (dx,) = torch.autograd.grad((y * y).sum(), xg)
    assert torch.equal(y.detach(), y_eval) and bool(torch.isfinite(dx).all())
    assert float(dx.abs().max()) > 0
