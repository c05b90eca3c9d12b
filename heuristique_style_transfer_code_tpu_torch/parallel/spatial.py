"""Spatial partitioning (``--shard_spatial``): each canvas's H rows over the
``spatial`` axis of a (data, spatial) mesh (``core/mesh.py``), the port of
JAX's ``P("data", "spatial")`` image sharding
(``parallel/sharding.py:100-143`` and the style optimisers' pixel
sharding of the JAX package).

Under jit GSPMD writes the conv halo exchanges and the all-reduce of every
sum over H and W. Here they are written out, and the ops take them while
``core.mesh.bands(mesh)`` is active (``active_bands``): then every NHWC
activation an op sees is this rank's band of rows of its image.

- Bands: rank s of S holds rows ``row_split(H, S)[s]`` of every map of
  height H, an even block split whose first H % S bands have one row more
  (a band is empty where H < S). A conv or pool of (k, s, p) over H gives
  each rank the band of its output's height, and needs the input rows
  [o0 s - p, (o1 - 1) s - p + k) (``RowSharding.input_rows``): its own and
  a halo that may reach past the neighbouring band where bands are thin.
- ``HaloRows`` fetches the rows of the image that this rank needs from
  their owners (one batch of point-to-point messages over the group); its
  backward sends their gradients back, where they are added. Padding is
  applied only at the image's top and bottom (zeros for a conv, -inf for
  the max-pool), never at a band edge.
- ``SpatialSum``: the sum over the group of per-rank partial sums, added
  in rank order from one all-gather (``Mesh.sum_in_order``), so every
  rank has the same bits; its backward is again that sum. Convention for
  the transpose: each rank differentiates the replicated loss divided by
  the group's size (``tasks/style_transfer.masked_adam_step``), so the sum
  of the ranks' gradients of a replicated value is its gradient, and a
  band's gradient is the whole image's.
- The banded ops: ``conv2d`` and ``max_pool2d`` (halo, then the library's
  op on the band), ``layer_norm_tail`` and ``global_avg_pool`` (statistics
  of the whole map from ``SpatialSum``), ``adaptive_avg_pool2d`` (each
  rank's part of each bin, summed over the group: replicated from there
  on), the Grams (``gram_fwd`` on the band gives fᵀf / hw_r; scaled by hw_r,
  summed, divided by the image's H·W; ``gram_bwd`` on the band), and the
  instance norm (``BandInstanceNorm``: the four band entry points of K3
  and K3′, their small per-(image, channel) partials exchanged and merged
  in rank order); in training (``parallel/sharding.make_sharded_train_step``
  on a 3-D mesh) the batch norm (``ops.norm.GlobalBatchNorm`` over the
  mesh's (data, spatial) plane) and, for the family-3 train variant's
  f32 islands, ``WholeRows``: its 3-channel downsampler
  (``avg_pool2d``) and its patch map's mean run on the whole map
  gathered from the bands, so that their f32 sums are the one device's.

Every op keeps its output connected to its input, an empty band's too, so
the autograd graph, and with it the order of the collectives in the
backward, is the same on every rank.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.mesh import Mesh, replicated
from ..ops.kernels._library import call

Rows = Tuple[int, int]


def row_split(height: int, n: int) -> List[Rows]:
    """[start, stop) of each of n bands of ``height`` rows: height // n rows
    each, one more for the first height % n."""
    base, extra = divmod(int(height), int(n))
    out, start = [], 0
    for r in range(n):
        stop = start + base + (1 if r < extra else 0)
        out.append((start, stop))
        start = stop
    return out


class RowSharding:
    """The bands of a map of ``height`` rows over ``ranks`` ranks: rank r
    holds rows ``rows(r)`` = [start, stop) (``row_split``)."""

    def __init__(self, height: int, ranks: int):
        self.height, self.ranks = int(height), int(ranks)
        self.bands: List[Rows] = row_split(self.height, self.ranks)

    def rows(self, rank: int) -> Rows:
        return self.bands[rank]

    def window(self, k: int, s: int, p: int) -> "RowSharding":
        """The bands of the output of a window of size k, stride s and
        padding p over this map."""
        return RowSharding((self.height + 2 * p - k) // s + 1, self.ranks)

    def input_rows(self, rank: int, k: int, s: int, p: int) -> Rows:
        """The rows [lo, hi) of this map (below 0 or from ``height`` on:
        padding) that ``rank``'s band of the window's output reads; (0, 0)
        for an empty band."""
        o0, o1 = self.window(k, s, p).rows(rank)
        if o1 <= o0:
            return 0, 0
        return o0 * s - p, (o1 - 1) * s - p + k


def heights(axis: Mesh, h: int) -> List[int]:
    """Every member's band height, in member order (one small all-gather)."""
    where = axis.device if axis.backend == "nccl" else torch.device("cpu")
    parts = axis.all_gather(torch.tensor([int(h)], dtype=torch.int64, device=where))
    return [int(p.item()) for p in parts]


def bounds_of(hs: Sequence[int]) -> List[Rows]:
    out, start = [], 0
    for h in hs:
        out.append((start, start + h))
        start += h
    return out


def _overlap(a: Rows, b: Rows) -> Rows:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if lo < hi else (0, 0)


class HaloRows(torch.autograd.Function):
    """``apply(x, axis, bounds, wants)``: rows ``wants[me]`` of the image
    (within it), from the bands ``bounds`` (each member's rows) of the
    NHWC tensors of the group, ``x`` this rank's band. Every member sends
    each other the rows of its band that the other wants; the backward
    sends the gradients of the rows received back to their owners and adds
    those of its own rows, in member order."""

    @staticmethod
    def forward(ctx, x, axis, bounds, wants):
        me = axis.rank
        start = bounds[me][0]
        rest = tuple(x.shape[2:])
        sends, receives = {}, {}
        for q in range(axis.world_size):
            if q == me:
                continue
            lo, hi = _overlap(bounds[me], wants[q])
            if hi > lo:
                sends[q] = x[:, lo - start:hi - start]
            lo, hi = _overlap(bounds[q], wants[me])
            if hi > lo:
                receives[q] = ((x.shape[0], hi - lo) + rest, x.dtype)
        got = axis.exchange(sends, receives)
        pieces = []
        for q in range(axis.world_size):
            lo, hi = _overlap(bounds[q], wants[me])
            if hi > lo:
                pieces.append(x[:, lo - start:hi - start] if q == me else got[q])
        ctx.axis, ctx.bounds, ctx.wants, ctx.shape = axis, bounds, wants, tuple(x.shape)
        if not pieces:
            return x.new_zeros((x.shape[0], 0) + rest)
        return torch.cat(pieces, dim=1)

    @staticmethod
    def backward(ctx, g):
        axis, bounds, wants = ctx.axis, ctx.bounds, ctx.wants
        me = axis.rank
        start = bounds[me][0]
        g = g.contiguous()
        dx = g.new_zeros(ctx.shape)
        sends, receives, off = {}, {}, 0
        for q in range(axis.world_size):
            lo, hi = _overlap(bounds[q], wants[me])
            if hi <= lo:
                continue
            piece = g[:, off:off + hi - lo]
            off += hi - lo
            if q == me:
                dx[:, lo - start:hi - start] += piece
            else:
                sends[q] = piece
        for q in range(axis.world_size):
            if q == me:
                continue
            lo, hi = _overlap(bounds[me], wants[q])
            if hi > lo:
                receives[q] = ((ctx.shape[0], hi - lo) + ctx.shape[2:], g.dtype)
        got = axis.exchange(sends, receives)
        for q in sorted(got):
            lo = _overlap(bounds[me], wants[q])[0]
            dx[:, lo - start:lo - start + got[q].shape[1]] += got[q]
        return dx, None, None, None


class SpatialSum(torch.autograd.Function):
    """``apply(axis, *tensors)``: each tensor summed over the group
    (``Mesh.sum_in_order``); the backward sums the ranks' gradients the
    same way (module docstring)."""

    @staticmethod
    def forward(ctx, axis, *tensors):
        ctx.axis = axis
        return tuple(axis.sum_in_order(tensors))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.axis.sum_in_order([g.contiguous() for g in grads]))


def _connected_empty(src: torch.Tensor, shape, dtype=None) -> torch.Tensor:
    """An empty tensor of ``shape`` whose gradient reaches ``src`` (zeros),
    so that an empty band's graph is every other band's."""
    return torch.zeros(shape, dtype=dtype or src.dtype, device=src.device) + src.sum() * 0


def _pair(v) -> Tuple[int, int]:
    return (int(v), int(v)) if isinstance(v, int) else (int(v[0]), int(v[1]))


def halo(x: torch.Tensor, axis: Mesh, k: int, s: int, p: int, pad_value: float):
    """This rank's input of a window (k, s, p) over H: the rows its output
    band reads, fetched from their owners and padded with ``pad_value`` at
    the image's top and bottom only; with its output band's height."""
    bounds = bounds_of(heights(axis, x.shape[1]))
    h = bounds[-1][1]
    sharding = RowSharding(h, axis.world_size)
    needs = [sharding.input_rows(q, k, s, p) for q in range(axis.world_size)]
    wants = []
    for lo, hi in needs:  # the rows within the image
        lo = min(max(lo, 0), h)
        wants.append((lo, max(min(hi, h), lo)))
    xh = HaloRows.apply(x, axis, bounds, wants)
    lo, hi = needs[axis.rank]
    top, bottom = max(0, -lo), max(0, hi - h)
    if hi > lo and (top or bottom):
        xh = F.pad(xh, (0, 0, 0, 0, top, bottom), value=pad_value)
    o0, o1 = sharding.window(k, s, p).rows(axis.rank)
    return xh, o1 - o0


def conv2d(x: torch.Tensor, weight: torch.Tensor, stride, padding, bias, axis: Mesh):
    """``ops.conv.conv2d`` on this rank's band of x: the output band."""
    kh, kw = weight.shape[2], weight.shape[3]
    (sh, sw), (ph, pw) = _pair(stride), _pair(padding)
    b = bias.to(x.dtype) if bias is not None else None
    n, _, w, _ = x.shape
    w_out = (w + 2 * pw - kw) // sw + 1
    if kh == 1 and sh == 1 and ph == 0:  # row for row: no halo
        xh, rows = x, x.shape[1]
    else:
        xh, rows = halo(x, axis, kh, sh, ph, 0.0)
    if rows == 0:  # connected to the weights too: a train step differentiates them
        y = _connected_empty(xh, (n, 0, w_out, weight.shape[0])) + weight.sum() * 0
        return y if bias is None else y + bias.sum() * 0
    y = F.conv2d(xh.permute(0, 3, 1, 2), weight.to(x.dtype), b, stride=(sh, sw),
                 padding=(0, pw))
    return y.permute(0, 2, 3, 1)


def max_pool2d(x: torch.Tensor, kernel_size, stride, padding, axis: Mesh):
    """``ops.conv.max_pool2d`` on this rank's band: -inf padding at the
    image's top and bottom, the neighbours' rows at a band edge."""
    (kh, kw), (sh, sw), (ph, pw) = _pair(kernel_size), _pair(stride), _pair(padding)
    xh, rows = halo(x, axis, kh, sh, ph, float("-inf"))
    n, _, w, c = x.shape
    if rows == 0:
        return _connected_empty(xh, (n, 0, (w + 2 * pw - kw) // sw + 1, c))
    y = F.max_pool2d(xh.permute(0, 3, 1, 2), (kh, kw), (sh, sw), (0, pw))
    return y.permute(0, 2, 3, 1)


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def image_mean(t: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """(B,) per-image mean over every non-batch dimension of the whole
    image, from this rank's band ``t`` (B, h, ...): its sums and its count
    summed over the group, in t's dtype."""
    dims = tuple(range(1, t.dim()))
    count = t.new_full((1,), float(torch.Size(t.shape[1:]).numel()))
    total, n = SpatialSum.apply(axis, t.sum(dim=dims), count)
    return total / n


def layer_norm_tail(x: torch.Tensor, eps: float, axis: Mesh) -> torch.Tensor:
    """``ops.norm.layer_norm_tail`` (statistics of the whole map over H, W
    and C, two-pass) on this rank's band."""
    xf = x.to(_acc(x.dtype))
    mean = image_mean(xf, axis).view(-1, 1, 1, 1)
    centred = xf - mean
    var = image_mean(centred.square(), axis).view(-1, 1, 1, 1)
    return (centred * torch.rsqrt(var + eps)).to(x.dtype)


def global_avg_pool(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """``ops.pooling.global_avg_pool`` of the whole map from this rank's
    band: (N, C), replicated."""
    xf = x.to(_acc(x.dtype))
    count = xf.new_full((1,), float(x.shape[1] * x.shape[2]))
    total, n = SpatialSum.apply(axis, xf.sum(dim=(1, 2)), count)
    return (total / n).to(x.dtype)


def _pool_weights(in_size: int, out_size: int, dtype, device) -> torch.Tensor:
    """(out, in) adaptive-average weights (``ops.pooling.adaptive_pool_matrix``'s
    bins) in ``dtype``."""
    p = torch.zeros((out_size, in_size), dtype=dtype, device=device)
    for i in range(out_size):
        start, end = (i * in_size) // out_size, -((-(i + 1) * in_size) // out_size)
        p[i, start:end] = 1.0 / (end - start)
    return p


def adaptive_avg_pool2d(x: torch.Tensor, output_size, axis: Mesh) -> torch.Tensor:
    """``ops.pooling.adaptive_avg_pool2d`` of the whole map: each rank's
    part of each bin (its rows of the bins' weights), summed over the
    group. The output is replicated."""
    oh, ow = _pair(output_size)
    bounds = bounds_of(heights(axis, x.shape[1]))
    start, stop = bounds[axis.rank]
    acc = _acc(x.dtype)
    ph = _pool_weights(bounds[-1][1], oh, acc, x.device)[:, start:stop]
    pw = _pool_weights(x.shape[2], ow, acc, x.device)
    part = torch.einsum("ih,bhwc,jw->bijc", ph, x.to(acc), pw)
    (total,) = SpatialSum.apply(axis, part)
    return total.to(x.dtype)


def gram(function, f: torch.Tensor, axis: Mesh, *args) -> torch.Tensor:
    """The Gram of the whole image from this rank's (N, hw_r, C) band ``f``:
    ``function.apply(f, *args)`` (``GramFunction``, ``PooledGramFunction``:
    the kernels on the band, their sums divided by hw_r) scaled by hw_r,
    summed over the group with the counts, divided by the image's H·W; the
    backward launches the kernel's backward on the band."""
    hw = f.shape[1]
    acc = _acc(f.dtype)
    if hw:
        part = function.apply(f, *args).to(acc) * float(hw)
    else:
        side = args[0] if args else f.shape[2]
        part = _connected_empty(f, (f.shape[0], side, side), acc)
    total, n = SpatialSum.apply(axis, part, part.new_full((1,), float(hw)))
    return (total / n).to(f.dtype)


def _chan_merge(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Members' (B, C, 3) band statistics (count, mean, M2 about the band's
    own mean) merged in member order (Chan et al.): (B, C, 3) of the image."""
    n, mean, m2 = parts[0].unbind(-1)
    for p in parts[1:]:
        nb, mb, m2b = p.unbind(-1)
        total = n + nb
        w = torch.where(total > 0, nb / total.clamp_min(1), torch.zeros_like(nb))
        d = mb - mean
        mean = mean + d * w
        m2 = m2 + m2b + d * d * n * w
        n = total
    return torch.stack([n, mean, m2], dim=-1)


class BandInstanceNorm(torch.autograd.Function):
    """The non-affine instance norm (``ops.norm.instance_norm``) of the
    whole image on this rank's (B, hw_r, C) band, with its optional ReLU.

    Forward: ``instance_norm_band_stats`` (the band's count, mean and M2
    about its own mean a (image, channel)), one all-gather of those
    (B, C, 3) partials, their merge in member order (the same bits on every
    rank), then ``instance_norm_band_apply`` with (mean, rstd, 1 / n).
    Backward: ``instance_norm_band_bwd_reduce`` (Σg and Σg·x̂, g the
    gradient under the ReLU mask read from y), their sum over the group
    in member order, then ``instance_norm_band_bwd_apply`` (dx). On the
    card each is a hand-written kernel; on the CPU its plain version."""

    @staticmethod
    def forward(ctx, x, eps, relu, axis):
        from ..ops.kernels import instance_norm as kin

        stats = call(kin.INSTANCE_NORM_BAND_STATS, x)
        merged = _chan_merge(axis.all_gather(stats))
        n, mean, m2 = merged.unbind(-1)
        coef = torch.stack([mean, torch.rsqrt(m2 / n + eps), 1.0 / n, torch.zeros_like(n)],
                           dim=-1).to(_acc(x.dtype)).contiguous()
        y = call(kin.INSTANCE_NORM_BAND_APPLY, x, coef, relu)
        ctx.axis, ctx.relu = axis, relu
        ctx.save_for_backward(x, coef, y if relu else None)
        return y

    @staticmethod
    def backward(ctx, dy):
        from ..ops.kernels import instance_norm as kin

        x, coef, y = ctx.saved_tensors
        dy = dy.contiguous()
        sums = call(kin.INSTANCE_NORM_BAND_BWD_REDUCE, x, dy, coef, ctx.relu, y)
        (total,) = ctx.axis.sum_in_order([sums])
        dx = call(kin.INSTANCE_NORM_BAND_BWD_APPLY, x, dy, coef, total, ctx.relu, y)
        return dx, None, None, None


def instance_norm(x: torch.Tensor, eps: float, relu: bool, axis: Mesh) -> torch.Tensor:
    """``ops.norm.instance_norm`` on this rank's NHWC band."""
    n, h, w, c = x.shape
    return BandInstanceNorm.apply(x.reshape(n, h * w, c), float(eps), bool(relu),
                                  axis).reshape(n, h, w, c)


class WholeRows(torch.autograd.Function):
    """``apply(band, axis)``: the whole NHWC maps from every member's band
    (``gather_canvas``); backward the sum over the group of the whole
    maps' gradients (in member order), of which this rank keeps its
    band's rows."""

    @staticmethod
    def forward(ctx, band, axis):
        whole = gather_canvas(band, axis)
        ctx.axis = axis
        ctx.rows = row_split(whole.shape[1], axis.world_size)[axis.rank]
        return whole

    @staticmethod
    def backward(ctx, g):
        (total,) = ctx.axis.sum_in_order([g.contiguous()])
        lo, hi = ctx.rows
        return total[:, lo:hi].contiguous(), None


def whole_rows(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    return WholeRows.apply(x, axis)


def avg_pool2d(x: torch.Tensor, kernel_size, stride, padding, count_include_pad: bool,
               axis: Mesh) -> torch.Tensor:
    """``ops.conv.avg_pool2d`` (f32 window sums) on this rank's band: the
    pool of the whole maps (``WholeRows``), whose output band this rank
    keeps. The multi-scale downsampler reads the 3-channel image."""
    from ..ops.conv import avg_pool2d as pool

    with replicated():
        y = pool(whole_rows(x, axis), kernel_size, stride, padding, count_include_pad)
    start, stop = row_split(y.shape[1], axis.world_size)[axis.rank]
    return y[:, start:stop]


def band_of(x: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """This rank's band of rows of whole NHWC images (a copy)."""
    start, stop = row_split(x.shape[1], axis.world_size)[axis.rank]
    return x[:, start:stop].contiguous()


def gather_canvas(band: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """The whole images from every member's band (on every member): one
    all-gather of the bands padded to the tallest."""
    hs = heights(axis, band.shape[1])
    tall = max(hs)
    pad = band.new_zeros((band.shape[0], tall - band.shape[1]) + tuple(band.shape[2:]))
    parts = axis.all_gather(torch.cat([band.detach(), pad], dim=1))
    return torch.cat([p[:, :h] for p, h in zip(parts, hs)], dim=1)


def total_variation(pixels: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """``tasks.style_transfer.total_variation`` of the whole images from
    this rank's band: the H differences with the row above the band (from
    its owner), the W differences of the band, each a mean over the
    image, in f32."""
    p = pixels.float()
    bounds = bounds_of(heights(axis, p.shape[1]))
    wants = [(max(lo - 1, 0), hi) if hi > lo else (0, 0) for lo, hi in bounds]
    ph = HaloRows.apply(p, axis, bounds, wants)
    dh = torch.square(ph[:, 1:] - ph[:, :-1])
    dw = torch.square(p[:, :, 1:] - p[:, :, :-1])
    return image_mean(dh, axis) + image_mean(dw, axis)
