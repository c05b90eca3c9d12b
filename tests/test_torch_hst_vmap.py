"""The seven ``hst`` ops under ``torch.func`` transforms (the port's
``ops/kernels/_library.py``): each op under ``vmap``, and under
``vmap(grad(...))`` through its shim (the autograd path that
``--parallel_folds`` takes), against a loop over the folds of its plain
version, in float64; each vmapped call is one call of the op's
implementation for all K folds (on the card: one kernel launch), and an
unvmapped operand is broadcast to the folds. A backward op still has no
gradient: under ``grad`` it raises only where a gradient of it is taken.

Tolerance: 1e-12 relative in float64 (the plain versions on a (K·N, ...)
batch against K calls on (N, ...) batches: the same sums)."""
import numpy as np
import pytest
import torch
from torch.func import grad, vmap

from heuristique_style_transfer_code_tpu_torch.ops.kernels import gram as kg
from heuristique_style_transfer_code_tpu_torch.ops.kernels import instance_norm as kin

K, N, L, C, S = 3, 2, 12, 8, 3
RTOL, ATOL = 1e-12, 1e-12


def _r(*shape, seed=0):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape))


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.fixture
def calls(monkeypatch):
    """Counts the implementation calls of every op (each wrapper, looked
    up in its module when the op runs)."""
    counts = {}
    for mod, names in ((kg, ("gram_fwd", "gram_bwd", "pooled_gram_fwd", "pooled_gram_bwd")),
                       (kin, ("instance_norm_fwd", "instance_norm_bwd"))):
        for name in names:
            real = getattr(mod, name)

            def counted(*a, _real=real, _name=name, **kw):
                counts[_name] = counts.get(_name, 0) + 1
                return _real(*a, **kw)

            monkeypatch.setattr(mod, name, counted)
    return counts


def _pooled_plain(f, s):
    return kg._pooled_gram_of_y(kg.pooled_gram_y_plain(f, s), f.dtype)


def test_forward_ops_under_vmap(calls):
    f = _r(K, N, L, C)
    x, sc, b = _r(K, N, L, C, seed=1), _r(K, N, C, seed=2).abs() + 0.5, _r(K, N, C, seed=3)
    _close(vmap(torch.ops.hst.gram_fwd)(f), torch.stack([kg.gram_fwd_plain(t) for t in f]))
    _close(vmap(torch.ops.hst.pooled_gram_fwd, in_dims=(0, None))(f, S),
           torch.stack([_pooled_plain(t, S) for t in f]))
    g, y = vmap(torch.ops.hst.pooled_gram_fwd_y, in_dims=(0, None))(f, S)
    _close(g, torch.stack([_pooled_plain(t, S) for t in f]))
    _close(y, torch.stack([kg.pooled_gram_y_plain(t, S) for t in f]))
    for relu in (False, True):
        got = vmap(torch.ops.hst.instance_norm_fwd, in_dims=(0, 0, 0, None, None))(
            x, sc, b, kin.EPS, relu)
        _close(got, torch.stack([kin.instance_norm_fwd_plain(x[k], sc[k], b[k], relu=relu)
                                 for k in range(K)]))
    assert calls == {"gram_fwd": 1, "pooled_gram_fwd": 2, "instance_norm_fwd": 2}


def test_backward_ops_under_vmap(calls):
    f, dg, ds = _r(K, N, L, C), _r(K, N, C, C, seed=1), _r(K, N, S, S, seed=2)
    y = torch.stack([kg.pooled_gram_y_plain(t, S) for t in f])
    _close(vmap(torch.ops.hst.gram_bwd)(f, dg),
           torch.stack([kg.gram_bwd_plain(f[k], dg[k]) for k in range(K)]))
    _close(vmap(torch.ops.hst.pooled_gram_bwd, in_dims=(0, 0, None, None))(
        y, ds, C, torch.float64),
        torch.stack([kg.pooled_gram_bwd_plain(y[k], ds[k], C, torch.float64) for k in range(K)]))
    x, dy, sc, b = _r(K, N, L, C), _r(K, N, L, C, seed=4), _r(K, N, C, seed=5), _r(K, N, C, seed=6)
    out = kin.instance_norm_fwd_plain(x.flatten(0, 1), sc.flatten(0, 1), b.flatten(0, 1),
                                      relu=True).unflatten(0, (K, N))
    got = vmap(torch.ops.hst.instance_norm_bwd, in_dims=(0, 0, 0, 0, None, None, 0))(
        x, dy, sc, b, kin.EPS, True, out)
    want = [kin.instance_norm_bwd_plain(x[k], dy[k], sc[k], b[k], kin.EPS, True, out[k])
            for k in range(K)]
    for a, w in zip(got, zip(*want)):
        _close(a, torch.stack(w))
    assert calls == {"gram_bwd": 1, "pooled_gram_bwd": 1, "instance_norm_bwd": 1}


def test_unvmapped_operands_are_broadcast(calls):
    """A fold-independent operand (the unit rows of ``ops/norm.instance_norm``)
    is broadcast, and an op of unvmapped operands alone runs once, unvmapped."""
    x, sc, b = _r(K, N, L, C), _r(N, C, seed=1).abs() + 0.5, _r(N, C, seed=2)
    got = vmap(torch.ops.hst.instance_norm_fwd, in_dims=(0, None, None, None, None))(
        x, sc, b, kin.EPS, False)
    _close(got, torch.stack([kin.instance_norm_fwd_plain(t, sc, b) for t in x]))
    f = _r(N, L, C)
    both = vmap(lambda a: torch.ops.hst.gram_fwd(f) + a)(_r(K, C, C, seed=3))
    _close(both[1] - _r(K, C, C, seed=3)[1], kg.gram_fwd_plain(f))
    assert calls == {"instance_norm_fwd": 1, "gram_fwd": 1}


def _grads_loop(loss_plain, *args):
    out = []
    for k in range(len(args[0])):
        leaves = [a[k].clone().requires_grad_(True) for a in args]
        out.append(torch.autograd.grad(loss_plain(*leaves), leaves))
    return [torch.stack(g) for g in zip(*out)]


def test_gram_shims_under_vmap_of_grad(calls):
    """``GramFunction`` and ``PooledGramFunction`` (forward and the
    gradient through ``gram_bwd`` and ``pooled_gram_bwd``) under
    ``vmap(grad(...))``: one call a op for the K folds."""
    f, w = _r(K, N, L, C), _r(K, N, S, S, seed=1)

    def loss(f, w):
        return (kg.GramFunction.apply(f).square().sum()
                + (kg.PooledGramFunction.apply(f, S) * w).sum())

    def plain(f, w):
        return kg.gram_fwd_plain(f).square().sum() + (_pooled_plain(f, S) * w).sum()

    got = vmap(grad(loss))(f, w)
    _close(got, _grads_loop(plain, f, w)[0])
    assert calls == {"gram_fwd": 1, "gram_bwd": 1, "pooled_gram_fwd": 1, "pooled_gram_bwd": 1}


@pytest.mark.parametrize("relu", [False, True])
def test_instance_norm_shim_under_vmap_of_grad(calls, relu):
    """``InstanceNormFunction`` under ``vmap(grad(...))`` with per-fold
    (K, N, C) rows, the gradients of x, scale and bias."""
    x, sc, b = _r(K, N, L, C), _r(K, N, C, seed=1).abs() + 0.5, _r(K, N, C, seed=2)
    w = _r(K, N, L, C, seed=3)

    def loss(x, sc, b):
        return (kin.InstanceNormFunction.apply(x, sc, b, kin.EPS, relu) * w[0]).sum()

    def plain(x, sc, b):
        return (kin.instance_norm_fwd_plain(x, sc, b, relu=relu) * w[0]).sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(x, sc, b)
    for a, want in zip(got, _grads_loop(plain, x, sc, b)):
        _close(a, want)
    assert calls == {"instance_norm_fwd": 1, "instance_norm_bwd": 1}


def test_instance_norm_per_fold_affine_reduces_to_folds():
    """Per-fold (K, C) affine rows expanded to the (N, C) rows the op
    takes: their gradients come back as (K, C), the sum over the images
    (the autograd of the expansion)."""
    x, sc, b = _r(K, N, L, C), _r(K, C, seed=1).abs() + 0.5, _r(K, C, seed=2)

    def loss(x, sc, b):
        rows = (sc.expand(N, C).contiguous(), b.expand(N, C).contiguous())
        return kin.InstanceNormFunction.apply(x, *rows, kin.EPS, True).square().sum()

    def plain(x, sc, b):
        return kin.instance_norm_fwd_plain(x, sc.expand(N, C), b.expand(N, C),
                                           relu=True).square().sum()

    got = vmap(grad(loss, argnums=(0, 1, 2)))(x, sc, b)
    assert got[1].shape == (K, C) and got[2].shape == (K, C)
    for a, want in zip(got, _grads_loop(plain, x, sc, b)):
        _close(a, want)


def test_grad_alone_and_eager_unchanged(calls):
    """``grad`` without ``vmap`` goes through the same Functions; outside a
    transform the shims take the eager path (no Function when nothing
    needs a gradient)."""
    f = _r(N, L, C)
    got = grad(lambda f: kg.GramFunction.apply(f).square().sum())(f)
    _close(got, _grads_loop(lambda f: kg.gram_fwd_plain(f).square().sum(), f[None])[0][0])
    _close(kg.GramFunction.apply(f), kg.gram_fwd_plain(f))
    assert calls == {"gram_fwd": 2, "gram_bwd": 1}


def test_backward_ops_refuse_a_gradient_only_where_taken():
    """Under ``grad`` (which always builds its gradient's graph) the first
    derivative through ``gram_bwd`` works; a second derivative raises."""
    f = _r(N, L, C)
    first = grad(lambda f: kg.GramFunction.apply(f).square().sum())
    first(f)
    with pytest.raises(RuntimeError, match="hst::gram_bwd has no gradient"):
        grad(lambda f: first(f).square().sum())(f)
