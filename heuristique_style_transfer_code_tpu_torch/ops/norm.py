"""Norms on NHWC tensors (``ops/norm.py`` of the JAX package): batch norm
in eval and train mode (``:29-67``), the non-affine instance norm
(``:70``) and the layer norm over every non-batch dimension (``:78``).
Statistics and arithmetic in f32 (f64 stays f64), one cast back to x's
dtype. Under ``core.mesh.bands`` (``--shard_spatial``) the instance norm
and the layer norm take the statistics of the whole image from every
rank's band (``parallel/spatial.py``)."""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.device import traced, transformed
from ..core.mesh import active, active_bands
from ..core.remat import recomputing
from .kernels.instance_norm import InstanceNormFunction

EPS = 1e-5
MOMENTUM = 0.1


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    eps: float = EPS,
    train: bool = False,
) -> torch.Tensor:
    """x: (N, H, W, C); per-channel (C,) scale/bias and running mean/var.

    Eval: the running statistics normalise. Train (torch's BatchNorm2d,
    as the JAX package's ``batch_norm(train=True)``): the batch's mean and
    biased variance over N, H and W normalise, and ``mean`` and ``var``
    are updated in place to (1 - 0.1) * running + 0.1 * batch, the variance
    taken unbiased (n = N*H*W). That is ``F.batch_norm``, a library call
    as the XLA ops were in JAX: on the channels_last view of x, statistics
    and arithmetic in f32 for f32 and bf16 inputs (f64 stays f64), the
    output in x's dtype and the f32 running buffers kept f32. While a remat
    block is recomputed for its backward (``core/remat.py``) the update
    goes to copies of the buffers, so a step updates them once. Under a
    ``torch.func`` transform (``--parallel_folds``) the same arithmetic is
    written out on the NHWC tensor (``_batch_norm_train_nhwc``). Within a
    data-parallel train step (``core.mesh.activate``) the statistics are
    those of the global batch (``GlobalBatchNorm``, under ``torch.func``
    too: ``--parallel_folds`` over a data axis of several ranks): no rank
    normalises by its own rows' statistics. They reduce over the mesh's
    (data, spatial) plane (``Mesh.replica_axis``); under ``core.mesh.bands``
    x is this rank's band of rows of its images, and n is the plane's
    all-reduced count, since bands may be uneven or empty."""
    if train:
        if recomputing():
            mean, var = mean.clone(), var.clone()
        dp = active()
        if dp is not None:
            return _global_batch_norm(x, scale, bias, mean, var, eps, dp[0])
        if transformed(x):
            return _batch_norm_train_nhwc(x, scale, bias, mean, var, eps)
        y = F.batch_norm(x.permute(0, 3, 1, 2), mean, var, scale, bias, training=True,
                         momentum=MOMENTUM, eps=eps)
        return y.permute(0, 2, 3, 1)
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    inv = scale.to(ctype) * torch.rsqrt(var.to(ctype) + eps)
    shift = bias.to(ctype) - mean.to(ctype) * inv
    return (x.to(ctype) * inv + shift).to(x.dtype)


def _batch_norm_train_nhwc(x, scale, bias, mean, var, eps):
    """``F.batch_norm(training=True)``'s arithmetic written out on the NHWC
    tensor, for a ``torch.func`` transform's tensors (``--parallel_folds``):
    there cuDNN's batch norm would copy each fold's channels_last view to
    channels_last, which ``vmap`` refuses, and an NCHW copy instead makes
    every convolution after it transpose (PERF.md). Statistics in
    f32 (f64 stays f64); the running buffers updated in place as torch's
    (the variance unbiased)."""
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.to(ctype)
    n = xc.numel() // xc.shape[-1]
    mu = xc.mean(dim=(0, 1, 2))
    centred = xc - mu
    v = centred.square().mean(dim=(0, 1, 2))
    mean.mul_(1.0 - MOMENTUM).add_(mu.detach() * MOMENTUM)
    var.mul_(1.0 - MOMENTUM).add_(v.detach() * (MOMENTUM * n / max(n - 1, 1)))
    y = centred * (torch.rsqrt(v + eps) * scale.to(ctype)) + bias.to(ctype)
    return y.to(x.dtype)


def _global_batch_norm(x, scale, bias, mean, var, eps, mesh):
    """``GlobalBatchNorm`` and the update of the running buffers in place
    (the mean, and the variance unbiased over the global n), outside the
    Function: under ``vmap`` ``mean`` and ``var`` are each fold's slice of
    the stacked buffers."""
    plane = mesh.replica_axis
    n = _global_n(x, plane)
    y, mu, v = GlobalBatchNorm.apply(x, scale, bias, eps, plane, n)
    mean.mul_(1.0 - MOMENTUM).add_(mu.detach() * MOMENTUM)
    if torch.is_tensor(n):
        var.mul_(1.0 - MOMENTUM).add_(v.detach() * (MOMENTUM * n / (n - 1).clamp_min(1)))
    else:
        var.mul_(1.0 - MOMENTUM).add_(v.detach() * (MOMENTUM * n / max(n - 1, 1)))
    return y


_STAT_DIMS = (-4, -3, -2)  # N, H, W of (..., N, H, W, C): a leading fold axis is kept


def _per_channel(t: torch.Tensor) -> torch.Tensor:
    """(..., C) statistics broadcast against (..., N, H, W, C)."""
    return t[..., None, None, None, :]


def _global_n(x: torch.Tensor, mesh):
    """The entries a channel's statistics cover over ``mesh`` (the
    plane): N H W of a rank's rows times the ranks, every rank holding
    B / N rows of whole images; under ``core.mesh.bands``, where a rank's
    band may be shorter or empty, the all-reduced sum of the ranks' N h W,
    a one-element tensor in the statistics' dtype."""
    local = x.shape[-4] * x.shape[-3] * x.shape[-2]
    if active_bands() is None:
        return float(local * mesh.world_size)
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    (n,) = mesh.all_reduce([torch.full((1,), float(local), dtype=ctype, device=x.device)])
    return n


def _bn_forward(x, scale, bias, eps, mesh, n):
    """(y, mean, biased variance) of the global batch of ``n`` entries a
    channel: the per-channel sums of every leading fold in one all-reduce,
    then their centred sums of squares in another."""
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    xc = x.to(ctype)
    (s,) = mesh.all_reduce([xc.sum(dim=_STAT_DIMS)])
    mu = s / n
    centred = xc - _per_channel(mu)
    (ss,) = mesh.all_reduce([centred.square().sum(dim=_STAT_DIMS)])
    v = ss / n
    invstd = torch.rsqrt(v + eps)
    y = centred * _per_channel(invstd * scale.to(ctype)) + _per_channel(bias.to(ctype))
    return y.to(x.dtype), mu, v


def _bn_backward(dy, x, scale, mu, v, eps, mesh, n):
    """(dx, dscale, dbias): the per-channel sums of dy and dy x̂ of every
    leading fold in one all-reduce; the scale's and bias's gradients this
    rank's partial sums."""
    ctype = mu.dtype
    invstd = torch.rsqrt(v + eps)
    xhat = (x.to(ctype) - _per_channel(mu)) * _per_channel(invstd)
    dyc = dy.to(ctype)
    sum_dy = dyc.sum(dim=_STAT_DIMS)
    sum_dy_xhat = (dyc * xhat).sum(dim=_STAT_DIMS)
    g_dy, g_dy_xhat = mesh.all_reduce([sum_dy, sum_dy_xhat])
    dx = _per_channel(scale.to(ctype) * invstd) * (
        dyc - _per_channel(g_dy / n) - xhat * _per_channel(g_dy_xhat / n))
    return dx.to(x.dtype), sum_dy_xhat.to(scale.dtype), sum_dy.to(scale.dtype)


class GlobalBatchNorm(torch.autograd.Function):
    """Train-mode batch norm over the global batch of a data-parallel step
    (the JAX package's ``batch_norm(train=True)`` on an array sharded over
    ``data``, ``ops/norm.py:51-65``), on each rank's NHWC rows (or band
    of rows): ``apply(x, scale, bias, eps, mesh, n) -> (y, mean, biased
    variance)``, ``n`` the entries a channel's statistics cover
    (``_global_n``).

    Forward, two-pass as JAX's (the mean first, then the mean of squared
    deviations, which stays accurate where the mean is large next to the
    spread): one all-reduce of the per-channel sums, one of the centred
    sums of squares. Backward (``GlobalBatchNormGrad``): one all-reduce of
    the per-channel sums of dy and dy x̂, so dx is the global batch's; the
    scale's and bias's gradients stay this rank's partial sums, which the
    step's gradient reduction adds up. Statistics and arithmetic in f32
    (f64 stays f64), the output in x's dtype.

    Under ``torch.func`` (``--parallel_folds`` over a mesh whose data axis
    has several ranks) the ``vmap`` rules take the K folds of a rank as one
    leading axis: the (K, C) sums of all its folds go in one collective, so
    a norm costs two collectives forward and one backward whatever K."""

    @staticmethod
    def forward(x, scale, bias, eps, mesh, n):
        return _bn_forward(x, scale, bias, eps, mesh, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, scale, _, eps, mesh, n = inputs
        _, mu, v = output
        ctx.save_for_backward(x, scale, mu, v)
        ctx.eps, ctx.mesh, ctx.n = eps, mesh, n
        ctx.mark_non_differentiable(mu, v)

    @staticmethod
    def backward(ctx, dy, _dmu, _dv):
        x, scale, mu, v = ctx.saved_tensors
        dx, dscale, dbias = GlobalBatchNormGrad.apply(dy, x, scale, mu, v, ctx.eps, ctx.mesh,
                                                      ctx.n)
        return dx, dscale, dbias, None, None, None

    @staticmethod
    def vmap(info, in_dims, x, scale, bias, eps, mesh, n):
        k = info.batch_size
        x, scale, bias = (_leading(t, d, k) for t, d in zip((x, scale, bias), in_dims))
        return _bn_forward(x, scale, bias, eps, mesh, n), (0, 0, 0)


class GlobalBatchNormGrad(torch.autograd.Function):
    """``GlobalBatchNorm``'s backward as a Function of its own, so that
    ``vmap`` reaches it with every fold of the rank at once: ``apply(dy,
    x, scale, mean, var, eps, mesh, n) -> (dx, dscale, dbias)``."""

    @staticmethod
    def forward(dy, x, scale, mu, v, eps, mesh, n):
        return _bn_backward(dy, x, scale, mu, v, eps, mesh, n)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("the global batch norm has no second derivative")

    @staticmethod
    def vmap(info, in_dims, dy, x, scale, mu, v, eps, mesh, n):
        k = info.batch_size
        args = (_leading(t, d, k) for t, d in zip((dy, x, scale, mu, v), in_dims))
        return _bn_backward(*args, eps, mesh, n), (0, 0, 0)


def _leading(t: torch.Tensor, dim: Optional[int], k: int) -> torch.Tensor:
    """A vmap rule's argument with its fold axis first (expanded where it
    has none)."""
    return t.expand(k, *t.shape) if dim is None else t.movedim(dim, 0)


@functools.lru_cache(maxsize=64)
def _unit_affine(c: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1, C) float32 ones and zeros on ``device``, made once per width,
    and never as inference tensors: made first under ``inference_mode``
    (evaluation, the camera), they would be refused later where the norm's
    gradient saves them (the style loop). Keyed on C alone, so a traced
    batch may be symbolic."""
    with torch.inference_mode(False):
        return (torch.ones((1, c), device=device, dtype=torch.float32),
                torch.zeros((1, c), device=device, dtype=torch.float32))


@functools.lru_cache(maxsize=64)
def _unit_rows(n: int, c: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``_unit_affine``'s rows copied to (N, C) once per shape (the kernel
    reads a dense (N, C) scale and bias), not as inference tensors either."""
    ones, zeros = _unit_affine(c, device)
    with torch.inference_mode(False):
        return ones.expand(n, c).contiguous(), zeros.expand(n, c).contiguous()


def instance_norm(x: torch.Tensor, eps: float = EPS, relu: bool = False) -> torch.Tensor:
    """Per-image, per-channel normalisation of x (N, H, W, C) over H and W,
    no affine; with ``relu`` the ReLU that follows it in the family-3
    discriminator is fused. The (N, HW, C) view goes through
    ``InstanceNormFunction`` with unit scale and zero bias (cached per
    shape; under ``torch.export``, whose batch may be symbolic, the (1, C)
    rows expanded in the program): on a CUDA tensor that launches
    ``instance_norm_fwd`` and, where a gradient flows (the family-3 style
    loop), ``instance_norm_bwd``; on a CPU tensor it takes the kernels'
    plain versions (f32 two-pass statistics). Under ``core.mesh.bands`` x
    is this rank's band: ``parallel.spatial.BandInstanceNorm``, whose
    statistics are the whole image's (the band entry points of both
    kernels)."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.instance_norm(x, eps, relu, axis)
    n, h, w, c = x.shape
    if traced(x):
        ones, zeros = _unit_affine(c, x.device)
        scale, bias = ones.expand(n, c).contiguous(), zeros.expand(n, c).contiguous()
    else:
        scale, bias = _unit_rows(n, c, x.device)
    y = InstanceNormFunction.apply(x.reshape(n, h * w, c), scale, bias, eps, relu)
    return y.reshape(n, h, w, c)


def layer_norm_tail(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """``F.layer_norm(x, x.shape[1:])`` without affine, in f32 (f64 stays
    f64), cast back once. It normalises H, W and C together, so the NHWC
    layout gives the result of the reference's NCHW one. The JAX package
    computes it as an XLA composition (no Pallas kernel), so PyTorch's own
    op serves here. Under ``core.mesh.bands``: the whole map's statistics
    from this rank's band."""
    axis = active_bands()
    if axis is not None:
        from ..parallel import spatial

        return spatial.layer_norm_tail(x, eps, axis)
    ctype = torch.float64 if x.dtype == torch.float64 else torch.float32
    return F.layer_norm(x.to(ctype), x.shape[1:], eps=eps).to(x.dtype)
