"""Tensor-parallel dense heads over the ``model`` axis of a mesh
(``core/mesh.py``): the port of JAX ``parallel/sharding.variable_shardings``'
column split of the ``fc``, ``classifier`` and ``feature_projection``
kernels (``P(None, "model")``), whose collectives GSPMD inserts under jit.

Here they are written out. A split head's torch weight (out, in) keeps
rows ``[m out / M, (m + 1) out / M)`` on model rank m (JAX's columns of its
(in, out) kernel), and its forward is ``column_linear``:

- ``CopyToModel`` on the head's input, which every model rank holds
  alike: the identity forward, and backward the sum over the model axis of
  the ranks' partial input gradients (in member order, so every rank gets
  the same bits);
- this rank's block of output columns, ``x Wₘᵀ`` (+ its block of the bias
  where the bias is split too);
- ``GatherColumns``: the blocks of every model rank, all-gathered into the
  whole output forward; backward this rank's block of the output's
  gradient, which every model rank holds alike;
- a replicated bias on a split weight (families 2 and 3's
  ``classifier.bias``, replicated in JAX too) is added after the gather, so
  every model rank computes the same gradient for it.

From the gather on, every model rank holds the same activations, so the
rest of the step, and every replicated leaf's gradient, is the same on
each. ``shard_heads`` narrows a built model's split leaves to this rank's
rows and routes its heads through ``column_linear``; ``gather_heads``
puts whole tensors back together (a collective: every rank calls it).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..core.mesh import Mesh


class CopyToModel(torch.autograd.Function):
    """``apply(x, axis)``: x, whose gradient is summed over ``axis``."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (total,) = ctx.axis.sum_in_order([g.contiguous()])
        return total, None


class GatherColumns(torch.autograd.Function):
    """``apply(y, axis)``: the (..., M w) concatenation of every member's
    (..., w) block, in member order; backward this member's block."""

    @staticmethod
    def forward(ctx, y, axis):
        ctx.axis, ctx.width = axis, y.shape[-1]
        return torch.cat(axis.all_gather(y.contiguous()), dim=-1)

    @staticmethod
    def backward(ctx, g):
        r, w = ctx.axis.rank, ctx.width
        return g[..., r * w:(r + 1) * w].contiguous(), None


def column_linear(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, axis: Mesh,
                  bias_split: bool) -> torch.Tensor:
    """``ops.linear.linear`` of a head whose (out / M, in) ``weight`` is
    this rank's block of rows over ``axis`` (module docstring)."""
    x = CopyToModel.apply(x, axis)
    y = F.linear(x, weight.to(x.dtype), bias.to(x.dtype) if bias_split else None)
    y = GatherColumns.apply(y, axis)
    return y if bias_split else y + bias.to(x.dtype)


def _part(t: torch.Tensor, dim: int, axis: Mesh) -> torch.Tensor:
    c = t.shape[dim] // axis.world_size
    return t.narrow(dim, axis.rank * c, c)


def shard_heads(model: torch.nn.Module, mesh: Mesh, shardings: Dict[str, Optional[int]]
                ) -> torch.nn.Module:
    """Place ``model`` on ``mesh``'s model axis in place (the JAX caller's
    ``device_put`` of ``variable_shardings``): each parameter with a split
    dimension in ``shardings`` ({state-dict key: dim or None}) keeps this
    rank's block of it (its own storage), and each ``ops.linear.Linear``
    whose weight is split runs ``column_linear``. Without a model axis of
    several ranks nothing changes."""
    from ..ops.linear import Linear

    axis = mesh.model_axis if mesh is not None else None
    if axis is None or axis.world_size == 1:
        return model
    with torch.no_grad():
        for name, p in model.named_parameters():
            dim = shardings.get(name)
            if dim is not None:
                p.data = _part(p.data, dim, axis).clone()
    for name, module in model.named_modules():
        prefix = f"{name}." if name else ""
        if isinstance(module, Linear) and shardings.get(prefix + "weight") is not None:
            module.column_split = (axis, shardings.get(prefix + "bias") is not None)
    return model


def split_leaves(model: torch.nn.Module) -> Dict[str, Mesh]:
    """{parameter name: model axis} of the leaves ``shard_heads`` split."""
    out = {}
    for name, module in model.named_modules():
        split = getattr(module, "column_split", None)
        if split is None:
            continue
        prefix = f"{name}." if name else ""
        out[prefix + "weight"] = split[0]
        if split[1]:
            out[prefix + "bias"] = split[0]
    return out


def gather_heads(model: torch.nn.Module,
                 tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
    """The whole tensors of ``tensors`` ({name: this rank's tensor}; the
    model's state dict by default): each split leaf's blocks all-gathered
    over the model axis (a collective), the others as they are."""
    tensors = dict(model.state_dict() if tensors is None else tensors)
    for name, axis in split_leaves(model).items():
        if name in tensors:
            tensors[name] = torch.cat(axis.all_gather(tensors[name].detach()), dim=0)
    return tensors


def shard_state_heads(model: torch.nn.Module, opt_state: dict) -> dict:
    """An ``sgd_momentum`` state of the whole model, its trace and EMA of
    the leaves ``shard_heads`` split narrowed to this rank's block, in
    place (the heads' state follows their parameters)."""
    split = {n: a for n, a in split_leaves(model).items() if n in opt_state["trace"]}
    with torch.no_grad():
        for part in ("trace", "ema"):
            for n, axis in split.items():
                if part in opt_state:
                    opt_state[part][n] = _part(opt_state[part][n], 0, axis).clone()
    if split:
        opt_state["model_split"] = list(split)
    return opt_state
