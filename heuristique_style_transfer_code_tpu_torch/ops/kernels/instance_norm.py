"""Wrapper of the hand-written instance-norm kernels (csrc/instance_norm.cu),
their plain PyTorch version, the launch plan and the launch count.

The wrapper takes the (B, HW, C) view of an NHWC activation and per-image
(B, C) float32 scale and bias rows. A tensor on the CPU goes through the
plain version; a CUDA tensor launches a kernel or raises — there is no
fallback. ``_plan`` picks the route: "cluster" (one launch, one
thread-block cluster per image, x read once where the image fits in the
cluster's shared memory) or "split" (three launches, x read twice), and
``instance_norm_plan_for`` reports it for a tensor. ``instance_norm_fwd``
is forward only, as the TPU kernel it replaces was, so a CUDA input that
needs a gradient raises there; ``InstanceNormFunction`` pairs it with
``instance_norm_bwd`` and is what the models call. ``_bwd_plan`` picks the
backward's route: "cluster" (one launch, a thread-block cluster per (image,
channel group), x, dy and y read once) or "split" (three launches on the
split geometry: per-block sums, their merge, the apply), and
``instance_norm_bwd_plan_for`` reports it. ``LAUNCHES["instance_norm_fwd"]``
and ``LAUNCHES["instance_norm_bwd"]`` count calls that launched a kernel
(one a call, whichever route). Both wrappers are also ``torch.library``
ops (``hst::instance_norm_fwd``, ``hst::instance_norm_bwd``, end of this
file; ``_library.py``), which ``InstanceNormFunction`` calls and ``torch.export`` records.

The banded entry points (``--shard_spatial``: each rank holds a band of
an image's rows, ``parallel.spatial.BandInstanceNorm``) split both
kernels at the split route's seam: ``instance_norm_band_stats`` (the
band's count, mean and M2 a (image, channel), about its own mean),
``instance_norm_band_apply`` (from the whole image's merged mean, rstd and
1 / n), ``instance_norm_band_bwd_reduce`` (Σg and Σg·x̂ of the band) and
``instance_norm_band_bwd_apply`` (dx from the whole image's sums). Each
has a plain version beside it, is an ``hst`` op, and counts its calls that
launched in ``BAND_LAUNCHES``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ._library import backward_op, call, define
from ._nvcc import CudaLibrary, check

KERNELS = ("instance_norm_fwd", "instance_norm_bwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# the banded entry points (--shard_spatial) count apart: no path without a
# spatial axis launches them
BAND_KERNELS = ("instance_norm_band_stats", "instance_norm_band_apply",
                "instance_norm_band_bwd_reduce", "instance_norm_band_bwd_apply")
BAND_LAUNCHES: Dict[str, int] = {name: 0 for name in BAND_KERNELS}
EPS = 1e-5

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # csrc/instance_norm.cu THREADS (split route)
_ITEMS = 8  # csrc/instance_norm.cu ITEMS
_BWD_ITEMS = 4  # csrc/instance_norm.cu BWD_ITEMS
_MAX_GRID_YZ = 65535
# the cluster route (csrc/instance_norm.cu)
_CL_THREADS = 256  # CL_THREADS
_MAX_CLUSTER = 16  # MAX_CLUSTER
_MAX_CHUNKS = 16  # MAX_CHUNKS: resident chunks, one mbarrier each
_MAX_SLOTS = 4  # MAX_SLOTS: ring stages
_MAX_CL_C = 256  # MAX_CL_C
_MAX_SMEM = 232448  # MAX_SMEM: a block's shared memory on sm_90
_CHUNK_BYTES = 16 * 1024  # a resident chunk's TMA copy (larger past 16 chunks)
_STAGE_BYTES = 64 * 1024  # a streamed stage
_SLOTS = 3  # ring stages where rows are streamed
_CLUSTER_SIZES = (16, 8, 4, 2, 1)  # k the plan tries, largest first
_SPREAD_SMEM = 120 * 1024  # more than half an SM's shared memory: one block an SM
_MIN_BLOCKS = 64  # fewer blocks than this in all (B x k) take the split route
# the backward's cluster route (csrc/instance_norm.cu in_bwd_cluster_kernel)
_BWD_GROUP_BYTES = (64, 32)  # a channel group's bytes of a row, in the order the plan tries
_BWD_CLUSTER_SIZES = (1, 2, 4, 8, 16)  # k the backward's plan tries, smallest first
_BWD_MIN_BLOCKS = 64  # blocks in all below which a larger k is tried


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hst_instance_norm_split.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, i, p]
    lib.hst_instance_norm_split.restype = i
    lib.hst_instance_norm_cluster.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, i, i, p]
    lib.hst_instance_norm_cluster.restype = i
    ip = ctypes.POINTER(i)
    lib.hst_instance_norm_cluster_occupancy.argtypes = [i, i, i, i, i, i, i, i, i, ip, ip]
    lib.hst_instance_norm_cluster_occupancy.restype = i
    lib.hst_instance_norm_bwd.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i,
                                          i, p]
    lib.hst_instance_norm_bwd.restype = i
    lib.hst_instance_norm_bwd_cluster.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, p]
    lib.hst_instance_norm_bwd_cluster.restype = i
    lib.hst_instance_norm_bwd_cluster_occupancy.argtypes = [i, i, i, i, i, i, ip, ip]
    lib.hst_instance_norm_bwd_cluster_occupancy.restype = i
    lib.hst_instance_norm_band_stats.argtypes = [p, p, p] + [i] * 9 + [p]
    lib.hst_instance_norm_band_apply.argtypes = [p, p, p] + [i] * 10 + [p]
    lib.hst_instance_norm_band_bwd_reduce.argtypes = [p] * 6 + [i] * 10 + [p]
    lib.hst_instance_norm_band_bwd_apply.argtypes = [p] * 6 + [i] * 10 + [p]
    for fn in (lib.hst_instance_norm_band_stats, lib.hst_instance_norm_band_apply,
               lib.hst_instance_norm_band_bwd_reduce, lib.hst_instance_norm_band_bwd_apply):
        fn.restype = i


LIBRARY = CudaLibrary("instance_norm", _bind)


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0
    for name in BAND_KERNELS:
        BAND_LAUNCHES[name] = 0


def instance_norm_fwd_plain(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                            eps: float = EPS, relu: bool = False) -> torch.Tensor:
    """(B, HW, C), (B, C) scale and bias -> (B, HW, C) in x's dtype: the
    composition of ``nn/transformer_net.py:94-104`` (f32 two-pass
    statistics, f64 stays f64; affine; ReLU; one cast back)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    mean = xf.mean(dim=1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * scale.to(acc)[:, None, :] + bias.to(acc)[:, None, :]
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def instance_norm_bwd_plain(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, eps: float = EPS, relu: bool = False,
                            y: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of ``instance_norm_fwd_plain``: (dx in x's dtype, dscale and
    dbias (B, C) in f32, f64 for f64 x). With xhat the normalised x, r =
    rsqrt(var + eps) and g = dy, times 1[y > 0] under ReLU (y the forward's
    output; recomputed here where not given): dbias = sum_HW g, dscale =
    sum_HW g xhat, dx = r scale (g - dbias / HW - xhat dscale / HW)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc)
    mean = xf.mean(dim=1, keepdim=True)
    r = torch.rsqrt(torch.square(xf - mean).mean(dim=1, keepdim=True) + eps)
    xhat = (xf - mean) * r
    g = dy.to(acc)
    if relu:
        if y is None:
            y = instance_norm_fwd_plain(x, scale, bias, eps, relu)
        g = torch.where(y > 0, g, torch.zeros_like(g))
    hw = x.shape[1]
    dbias = g.sum(dim=1)
    dscale = (g * xhat).sum(dim=1)
    dx = r * scale.to(acc)[:, None, :] * (g - dbias[:, None, :] / hw
                                          - xhat * dscale[:, None, :] / hw)
    return dx.to(x.dtype), dscale, dbias


def _geometry(c: int, hw: int, vec_width: int, items: int = _ITEMS):
    """Block geometry of the split route (and, with ``_BWD_ITEMS``, of the
    backward) for C channels read ``vec_width`` at a time: (cb, rl, splits,
    groups) — vector columns and row lanes per block, blocks along HW and
    along C."""
    cv = c // vec_width
    cb = min(cv, _THREADS)
    rl = _THREADS // cb
    splits = math.ceil(hw / (rl * items))
    groups = math.ceil(cv / cb)
    return cb, rl, splits, groups


class Plan(NamedTuple):
    """How ``instance_norm_fwd`` launches. route: "cluster" or "split".
    On the cluster route: k blocks an image (its cluster); each keeps up to
    res_rows of its rows resident in shared memory, in TMA chunks of
    chunk_rows, and streams the rest through `slots` ring stages of
    stage_rows (0 and 0 where every row is resident); smem is what a block
    asks for (at least ``_SPREAD_SMEM`` where spread, so that no two blocks
    share an SM); clusters is how many such clusters the card holds at
    once. On the split route every number is 0."""
    route: str
    k: int = 0
    res_rows: int = 0
    chunk_rows: int = 0
    stage_rows: int = 0
    slots: int = 0
    smem: int = 0
    clusters: int = 0


SPLIT = Plan("split")


def _block_rows(hw: int, k: int) -> List[Tuple[int, int]]:
    """[begin, end) of HW rows for each block of an image's cluster, as the
    kernel takes them: HW // k rows each, one more for the first HW % k."""
    base, extra = divmod(hw, k)
    out = []
    for r in range(k):
        begin = r * base + min(r, extra)
        out.append((begin, begin + base + (1 if r < extra else 0)))
    return out


def _block_split(hw: int, k: int, res_rows: int) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """For each block, its streamed rows [begin, end) (read twice: for the
    statistics and again for the apply) and its resident rows (read once),
    as the kernel takes them: the streamed ones first."""
    out = []
    for begin, end in _block_rows(hw, k):
        split = end - min(end - begin, res_rows)
        out.append(((begin, split), (split, end)))
    return out


def _cluster_smem(c: int, elem: int, k: int, res_rows: int, stage_rows: int, slots: int) -> int:
    """Shared memory a cluster-route block uses, as csrc/instance_norm.cu
    ClusterLayout counts it: resident rows, ring, two [k][C] exchange
    buffers, the block sum's [threads][V] partials, [3][C] coefficients,
    the mbarriers (chunks, ring slots, two exchanges)."""
    row = c * elem
    return (res_rows * row + slots * stage_rows * row + 2 * k * c * 4
            + _CL_THREADS * (16 // elem) * 4 + 3 * c * 4 + 8 * (_MAX_CHUNKS + _MAX_SLOTS + 2))


def _chunk_rows(res_rows: int, row: int) -> int:
    """Resident rows a TMA chunk: ``_CHUNK_BYTES`` of them, or more where
    that would make more than ``_MAX_CHUNKS`` chunks."""
    return max(1, _CHUNK_BYTES // row, -(-res_rows // _MAX_CHUNKS))


def _cluster_candidate(hw: int, c: int, elem: int, k: int, spread: bool, full: bool,
                       stage_bytes: int = _STAGE_BYTES,
                       slots: int = _SLOTS, cap: int = _MAX_SMEM) -> Optional[Plan]:
    """The cluster-route plan of k blocks an image: every row resident
    (full), or as many as fit in ``cap`` bytes beside a ring of `slots`
    stages of ``stage_bytes`` that streams the rest; None where it does not
    fit."""
    row = c * elem
    longest = -(-hw // k)
    if full or _cluster_smem(c, elem, k, longest, 0, 0) <= cap:  # every row resident: no ring
        res, stage_rows, slots = longest, 0, 0
    else:
        stage_rows = max(1, stage_bytes // row)
        res = (cap - _cluster_smem(c, elem, k, 0, stage_rows, slots)) // row
        if res < 1:
            return None
    used = _cluster_smem(c, elem, k, res, stage_rows, slots)
    if used > cap:
        return None
    return Plan("cluster", k, res, _chunk_rows(res, row), stage_rows, slots,
                max(used, _SPREAD_SMEM if spread else 0))


def _cluster_route_ok(b: int, c: int, elem: int, aligned: bool) -> bool:
    """Whether the cluster route takes the input at all: whole 16-byte
    vectors of C <= 256 channels on 16-byte-aligned x and y, and enough
    images to fill the card's SMs with their clusters' blocks."""
    return (aligned and c % (16 // elem) == 0 and c <= _MAX_CL_C and b <= _MAX_GRID_YZ
            and b * _MAX_CLUSTER >= _MIN_BLOCKS)


def _plan(b: int, hw: int, c: int, elem: int, aligned: bool,
          active: Callable[[Plan], int]) -> Plan:
    """How ``instance_norm_fwd`` launches on a (b, hw, c) input of elem-byte
    elements. ``active(plan)`` is how many clusters of the plan's shape the
    card holds at once (cudaOccupancyMaxActiveClusters on the card).

    The split route where the cluster route does not take the input
    (``_cluster_route_ok``). Otherwise, of k in ``_CLUSTER_SIZES``, the
    largest (the most SMs streaming) that keeps every row resident with one
    block an SM and all b clusters resident at once; failing that, the
    largest whose blocks fill an SM, keep the rows that fit beside a ring of
    ``_SLOTS`` stages of ``_STAGE_BYTES`` and stream the rest, with all b
    clusters at once; failing that (more images than the card holds
    clusters), the largest k that keeps every row resident, or k = 16 and
    streaming. On an H100 SXM at most 7 clusters of 16 such blocks are
    resident at once, and 15 of 8, so B = 8 takes k = 8."""
    if not _cluster_route_ok(b, c, elem, aligned):
        return SPLIT
    for full in (True, False):
        for k in _CLUSTER_SIZES:
            plan = _cluster_candidate(hw, c, elem, k, spread=True, full=full)
            if plan is None:
                continue
            n = active(plan)
            if n >= b:
                return plan._replace(clusters=n)
    for k in _CLUSTER_SIZES:
        plan = _cluster_candidate(hw, c, elem, k, spread=True, full=True)
        if plan is not None:
            return plan._replace(clusters=active(plan))
    plan = _cluster_candidate(hw, c, elem, _MAX_CLUSTER, spread=True, full=False)
    return plan._replace(clusters=active(plan))


@functools.lru_cache(maxsize=256)
def _occupancy(device_index: int, hw: int, c: int, elem: int, plan: Plan) -> int:
    """cudaOccupancyMaxActiveClusters of the plan's kernel and shape."""
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = LIBRARY.load().hst_instance_norm_cluster_occupancy(
            hw, c, plan.k, plan.res_rows, plan.chunk_rows, plan.stage_rows, plan.slots,
            plan.smem, 0 if elem == 4 else 1, ctypes.byref(clusters),
            ctypes.byref(smem))
    check("instance_norm_fwd occupancy", err)
    if smem.value != plan.smem:
        raise RuntimeError(f"instance_norm_fwd: shared memory {plan.smem} planned, the kernel "
                           f"counts {smem.value}")
    return clusters.value


@functools.lru_cache(maxsize=256)
def _plan_on(device_index: int, b: int, hw: int, c: int, elem: int, aligned: bool) -> Plan:
    return _plan(b, hw, c, elem, aligned,
                 lambda p: _occupancy(device_index, hw, c, elem, p._replace(clusters=0)))


def _aligned(x: torch.Tensor, y: Optional[torch.Tensor] = None) -> bool:
    return x.data_ptr() % 16 == 0 and (y is None or y.data_ptr() % 16 == 0)


def instance_norm_plan_for(x: torch.Tensor) -> Plan:
    """``_plan`` for a CUDA (B, HW, C) tensor, the card queried for its
    cluster occupancy (the output, fresh from the allocator, is aligned)."""
    b, hw, c = x.shape
    return _plan_on(x.device.index if x.device.index is not None else torch.cuda.current_device(),
                    b, hw, c, x.element_size(), _aligned(x))


def plan_traffic(plan: Plan, b: int, hw: int, c: int, elem: int) -> Tuple[float, int]:
    """(resident share, bytes read a second time) of a plan: the share of
    x's rows that stay in shared memory between the passes, and the bytes
    of x read again for the apply (streamed rows on the cluster route,
    every row on the split route)."""
    if plan.route == "split":
        return 0.0, b * hw * c * elem
    streamed = sum(s1 - s0 for (s0, s1), _ in _block_split(hw, plan.k, plan.res_rows))
    return 1.0 - streamed / hw, b * streamed * c * elem


def instance_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = EPS, relu: bool = False) -> torch.Tensor:
    """(B, HW, C), (B, C) f32 scale and bias -> (B, HW, C) in x's dtype.
    CPU: the plain version; CUDA: the kernel, on the route that
    ``instance_norm_plan_for`` picks."""
    if x.device.type == "cpu":
        return instance_norm_fwd_plain(x, scale, bias, eps, relu)
    name = "instance_norm_fwd"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"{name}: expected (B, HW, C), got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(
            f"{name}: (B, HW, C) input is not contiguous (strides {x.stride()}); "
            "keep activations in channels_last so the NHWC view needs no copy"
        )
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        raise NotImplementedError(f"{name} is forward only: it has no backward kernel")
    b, hw, c = x.shape
    for label, t in (("scale", scale), ("bias", bias)):
        if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (b, c):
            raise ValueError(f"{name}: {label} must be ({b}, {c}) float32 on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous")
    if b == 0 or hw == 0 or c == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    y = torch.empty_like(x)
    _launch(LIBRARY.load(), x, scale, bias, y, instance_norm_plan_for(x), eps, relu)
    LAUNCHES[name] += 1
    return y


def _launch(lib: ctypes.CDLL, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
            y: torch.Tensor, plan: Plan, eps: float, relu: bool) -> None:
    """One launch of ``plan`` from ``lib`` (the library, or a build of the
    same source with its phase marks on) on checked tensors; counts
    nothing. Measurements that compare plans call it directly."""
    name = "instance_norm_fwd"
    b, hw, c = x.shape
    if plan.route == "cluster" and not _aligned(x, y):
        plan = SPLIT  # the allocator's output is aligned; x may not be
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dtype = _DTYPE_CODE[x.dtype]
    if plan.route == "cluster":
        err = lib.hst_instance_norm_cluster(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), b, hw, c, plan.k,
            plan.res_rows, plan.chunk_rows, plan.stage_rows, plan.slots, plan.smem,
            float(eps), int(relu), dtype, stream)
    else:
        width = 16 // x.element_size()
        vec = c % width == 0 and _aligned(x, y)
        cb, rl, splits, groups = _geometry(c, hw, width if vec else 1)
        if b > _MAX_GRID_YZ or groups > _MAX_GRID_YZ:
            raise ValueError(f"{name}: B={b} or C={c} exceeds the kernel's grid")
        ws = torch.empty((b, splits, c, 2), device=x.device, dtype=torch.float32)
        coef = torch.empty((b, c, 4), device=x.device, dtype=torch.float32)
        err = lib.hst_instance_norm_split(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(),
            coef.data_ptr(), b, hw, c, cb, rl, splits, groups, float(eps), int(relu), int(vec),
            dtype, stream)
    check(name, err)


class BwdPlan(NamedTuple):
    """How ``instance_norm_bwd`` launches. route: "cluster" or "split". On
    the cluster route: one cluster of k blocks an (image, group of g
    channels); smem is the shared memory a block asks for; clusters is how
    many such clusters the card holds at once. On the split route every
    number is 0."""
    route: str
    g: int = 0
    k: int = 0
    smem: int = 0
    clusters: int = 0


BWD_SPLIT = BwdPlan("split")


def _bwd_smem(hw: int, g: int, k: int, elem: int, relu: bool) -> int:
    """Shared memory a cluster-route backward block uses, as
    csrc/instance_norm.cu BwdLayout counts it: the longest block's strips
    of x, g and (under ReLU) y, the [k][G] float4 exchange, the block sums'
    [8][2][G] f32 partials, the [4][G] f32 coefficients, one mbarrier."""
    strip = -(-hw // k) * g * elem
    return (3 if relu else 2) * strip + k * g * 16 + 2 * 8 * g * 4 + 4 * g * 4 + 8


def bwd_tiles(plan: BwdPlan, hw: int, c: int) -> List[List[Tuple[int, int, int, int]]]:
    """The cluster route's partition of one image: for each channel group,
    its blocks in rank order as (first channel, end channel, first row, end
    row); the last group is partial where g does not divide C."""
    return [[(c0, min(c, c0 + plan.g), r0, r1) for r0, r1 in _block_rows(hw, plan.k)]
            for c0 in range(0, c, plan.g)]


def _bwd_plan(b: int, hw: int, c: int, elem: int, aligned: bool, relu: bool,
              active: Callable[[BwdPlan], int]) -> BwdPlan:
    """How ``instance_norm_bwd`` launches on a (b, hw, c) input of
    elem-byte elements. ``active(plan)`` is how many clusters of the plan's
    shape the card holds at once (cudaOccupancyMaxActiveClusters).

    The split route where C is not a whole number of 16-byte vectors or a
    pointer is not 16-byte aligned. Otherwise the first (g, k) that gives
    at least ``_BWD_MIN_BLOCKS`` blocks in all (b x ceil(c / g) x k), keeps
    each block's strips in its shared memory and all clusters resident at
    once: groups of 64 bytes of a row, then of 32, each with k = 1, 2, 4,
    8; then k = 16 (non-portable) with 32-byte groups, then 64-byte ones,
    whatever the blocks. On an H100 (tools/instance_norm_bwd_sweep.py) 64
    blocks of 64-byte rows beat 128 of 32-byte rows at the style loop's b1
    shapes, k = 16 is the slowest size, and the card spreads the blocks
    over distinct SMs by itself. The split route where nothing fits (the
    net's f32 b8 shapes under ReLU, b32: their strips outgrow the card's
    shared memory)."""
    v = 16 // elem
    if not aligned or c % v != 0 or b > _MAX_GRID_YZ:
        return BWD_SPLIT
    order = [(gb // elem, k) for gb in _BWD_GROUP_BYTES for k in _BWD_CLUSTER_SIZES[:-1]]
    order += [(gb // elem, _BWD_CLUSTER_SIZES[-1]) for gb in reversed(_BWD_GROUP_BYTES)]
    for g, k in order:
        groups = -(-c // g)
        if k > hw or groups > _MAX_GRID_YZ:
            continue
        if b * groups * k < _BWD_MIN_BLOCKS and k < _BWD_CLUSTER_SIZES[-1]:
            continue
        plan = BwdPlan("cluster", g, k, _bwd_smem(hw, g, k, elem, relu))
        if plan.smem > _MAX_SMEM:
            continue
        n = active(plan)
        if n >= b * groups:
            return plan._replace(clusters=n)
    return BWD_SPLIT


@functools.lru_cache(maxsize=256)
def _bwd_occupancy(device_index: int, hw: int, c: int, elem: int, relu: bool,
                   plan: BwdPlan) -> int:
    """cudaOccupancyMaxActiveClusters of the backward plan's kernel and shape."""
    clusters, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = LIBRARY.load().hst_instance_norm_bwd_cluster_occupancy(
            hw, c, plan.g, plan.k, int(relu), 0 if elem == 4 else 1, ctypes.byref(clusters),
            ctypes.byref(smem))
    check("instance_norm_bwd occupancy", err)
    if smem.value != plan.smem:
        raise RuntimeError(f"instance_norm_bwd: shared memory {plan.smem} planned, the kernel "
                           f"counts {smem.value}")
    return clusters.value


@functools.lru_cache(maxsize=256)
def _bwd_plan_on(device_index: int, b: int, hw: int, c: int, elem: int, aligned: bool,
                 relu: bool) -> BwdPlan:
    return _bwd_plan(b, hw, c, elem, aligned, relu,
                     lambda p: _bwd_occupancy(device_index, hw, c, elem, relu,
                                              p._replace(clusters=0)))


def instance_norm_bwd_plan_for(x: torch.Tensor, relu: bool = False,
                               dy: Optional[torch.Tensor] = None,
                               y: Optional[torch.Tensor] = None) -> BwdPlan:
    """``_bwd_plan`` for a CUDA (B, HW, C) x (and the dy and, under ReLU,
    the y given with it), the card queried for its cluster occupancy (dx,
    fresh from the allocator, is aligned)."""
    b, hw, c = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy, y) if t is not None)
    return _bwd_plan_on(x.device.index if x.device.index is not None
                        else torch.cuda.current_device(),
                        b, hw, c, x.element_size(), aligned, relu)


def instance_norm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, eps: float = EPS, relu: bool = False,
                      y: Optional[torch.Tensor] = None, *, _plan: Optional[BwdPlan] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, HW, C) x and dy (x's dtype), (B, C) f32 scale and bias, and under
    ReLU the forward's output y -> (dx, dscale, dbias). CPU: the plain
    version; CUDA: the kernel on the route that
    ``instance_norm_bwd_plan_for`` picks (``_plan`` forces one, for
    measurements), which reads the ReLU mask from y and needs no bias."""
    if x.device.type == "cpu":
        return instance_norm_bwd_plain(x, dy, scale, bias, eps, relu, y)
    name = "instance_norm_bwd"
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"{name}: expected (B, HW, C), got shape {tuple(x.shape)}")
    b, hw, c = x.shape
    if relu and y is None:
        raise ValueError(f"{name}: relu needs the forward's output y for its mask")
    for label, t in (("x", x), ("dy", dy)) + ((("y", y),) if relu else ()):
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"{name}: {label} must be {tuple(x.shape)} {x.dtype} on {x.device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} is not contiguous (strides {t.stride()})")
    if scale.device != x.device or scale.dtype != torch.float32 or tuple(scale.shape) != (b, c) \
            or not scale.is_contiguous():
        raise ValueError(f"{name}: scale must be contiguous ({b}, {c}) float32 on {x.device}, "
                         f"got {tuple(scale.shape)} {scale.dtype} on {scale.device}")
    if b == 0 or hw == 0 or c == 0:
        raise ValueError(f"{name}: empty input {tuple(x.shape)}")
    plan = _plan or instance_norm_bwd_plan_for(x, relu, dy, y if relu else None)
    dx = torch.empty_like(x)
    dscale = torch.empty((b, c), device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    lib, stream = LIBRARY.load(), torch.cuda.current_stream(x.device).cuda_stream
    y_ptr = y.data_ptr() if relu else None
    if plan.route == "cluster":  # a plan the kernel cannot take is refused, not rerouted
        err = lib.hst_instance_norm_bwd_cluster(
            x.data_ptr(), dy.data_ptr(), y_ptr, scale.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), b, hw, c, plan.g, plan.k, float(eps), int(relu),
            _DTYPE_CODE[x.dtype], stream)
    else:
        width = 16 // x.element_size()
        vec = c % width == 0 and all(t.data_ptr() % 16 == 0
                                     for t in (x, dy, dx) + ((y,) if relu else ()))
        cb, rl, splits, groups = _geometry(c, hw, width if vec else 1, _BWD_ITEMS)
        if b > _MAX_GRID_YZ or groups > _MAX_GRID_YZ:
            raise ValueError(f"{name}: B={b} or C={c} exceeds the kernel's grid")
        ws = torch.empty((b, splits, c, 4), device=x.device, dtype=torch.float32)
        coef = torch.empty((b, c, 2, 4), device=x.device, dtype=torch.float32)
        err = lib.hst_instance_norm_bwd(
            x.data_ptr(), dy.data_ptr(), y_ptr, scale.data_ptr(), dx.data_ptr(),
            dscale.data_ptr(), dbias.data_ptr(), ws.data_ptr(), coef.data_ptr(), b, hw, c, cb, rl,
            splits, groups, float(eps), int(relu), int(vec), _DTYPE_CODE[x.dtype], stream)
    check(name, err)
    LAUNCHES[name] += 1
    return dx, dscale, dbias


# ------------------------------------------------- banded entry points


def instance_norm_band_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """(B, hw, C) band -> (B, C, 3): its count, mean and M2 (the sum of
    squared deviations from that mean) a (image, channel), in f32 (f64 for
    f64 x)."""
    acc = _stat_dtype(x.dtype)
    xf = x.to(acc)
    mean = xf.sum(dim=1) / max(x.shape[1], 1)  # an empty band: (0, 0, 0)
    m2 = torch.square(xf - mean[:, None, :]).sum(dim=1)
    return torch.stack([torch.full_like(mean, float(x.shape[1])), mean, m2], dim=-1)


def _coef_parts(coef: torch.Tensor):
    """(mean, rstd, 1 / n) of a (B, C, 4) coefficient tensor, as (B, 1, C)."""
    return coef[..., 0][:, None, :], coef[..., 1][:, None, :], coef[..., 2][:, None, :]


def instance_norm_band_apply_plain(x: torch.Tensor, coef: torch.Tensor,
                                   relu: bool = False) -> torch.Tensor:
    """y = (x - mean) * rstd (ReLU), the whole image's (mean, rstd, 1 / n, 0)
    in ``coef`` (B, C, 4), in x's dtype."""
    mean, rstd, _ = _coef_parts(coef)
    y = (x.to(coef.dtype) - mean) * rstd
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y.to(x.dtype)


def _band_grad(x, dy, coef, relu, y):
    g = dy.to(coef.dtype)
    if relu:
        g = torch.where(y > 0, g, torch.zeros_like(g))
    mean, rstd, inv_n = _coef_parts(coef)
    return g, (x.to(coef.dtype) - mean) * rstd, rstd, inv_n


def instance_norm_band_bwd_reduce_plain(x, dy, coef, relu=False, y=None) -> torch.Tensor:
    """(B, C, 2): the band's Σg and Σg·x̂ a (image, channel), g = dy (under
    ReLU where y > 0), x̂ = (x - mean) rstd."""
    g, xhat, _, _ = _band_grad(x, dy, coef, relu, y)
    return torch.stack([g.sum(dim=1), (g * xhat).sum(dim=1)], dim=-1)


def instance_norm_band_bwd_apply_plain(x, dy, coef, sums, relu=False, y=None) -> torch.Tensor:
    """dx = rstd ((g - Σg / n) - x̂ Σg·x̂ / n) in x's dtype, ``sums`` (B, C, 2)
    the whole image's."""
    g, xhat, rstd, inv_n = _band_grad(x, dy, coef, relu, y)
    mg = sums[..., 0][:, None, :] * inv_n
    mh = sums[..., 1][:, None, :] * inv_n
    return (rstd * ((g - mg) - xhat * mh)).to(x.dtype)


def _check_band(name: str, x: torch.Tensor, *others) -> None:
    """A CUDA band (B, hw, C) of f32 or bf16, contiguous; ``others``: more
    tensors of x's shape and dtype (dy, y)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} not supported (float32 or bfloat16)")
    if x.dim() != 3:
        raise ValueError(f"{name}: expected (B, HW, C), got shape {tuple(x.shape)}")
    for t in (x,) + others:
        if t.device != x.device or t.dtype != x.dtype or t.shape != x.shape \
                or not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous {tuple(x.shape)} {x.dtype} "
                             f"on {x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")
    if x.shape[0] > _MAX_GRID_YZ:
        raise ValueError(f"{name}: B={x.shape[0]} exceeds the kernel's grid")


def _check_small(name: str, label: str, t: torch.Tensor, x: torch.Tensor, k: int) -> None:
    b, _, c = x.shape
    if t.device != x.device or t.dtype != torch.float32 or tuple(t.shape) != (b, c, k) \
            or not t.is_contiguous():
        raise ValueError(f"{name}: {label} must be contiguous ({b}, {c}, {k}) float32 on "
                         f"{x.device}, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _band_geometry(name: str, x: torch.Tensor, items: int, *others):
    """(cb, rl, splits, groups, vec) of the split route over the band."""
    b, hw, c = x.shape
    width = 16 // x.element_size()
    vec = c % width == 0 and all(t.data_ptr() % 16 == 0 for t in (x,) + others)
    cb, rl, splits, groups = _geometry(c, hw, width if vec else 1, items)
    if groups > _MAX_GRID_YZ:
        raise ValueError(f"{name}: C={c} exceeds the kernel's grid")
    return cb, rl, splits, groups, int(vec)


def _stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def instance_norm_band_stats(x: torch.Tensor) -> torch.Tensor:
    """(B, hw, C) band -> (B, C, 3) (count, mean, M2). CPU: plain; CUDA: the
    split route's statistics pass on the band, shifted by the band's first
    row, and a merge of its blocks (two launches, one count); an empty band
    launches nothing."""
    if x.device.type == "cpu":
        return instance_norm_band_stats_plain(x)
    name = "instance_norm_band_stats"
    _check_band(name, x)
    b, hw, c = x.shape
    stats = torch.zeros((b, c, 3), device=x.device, dtype=torch.float32)
    if b == 0 or hw == 0 or c == 0:
        return stats
    cb, rl, splits, groups, vec = _band_geometry(name, x, _ITEMS)
    ws = torch.empty((b, splits, c, 2), device=x.device, dtype=torch.float32)
    check(name, LIBRARY.load().hst_instance_norm_band_stats(
        x.data_ptr(), ws.data_ptr(), stats.data_ptr(), b, hw, c, cb, rl, splits, groups, vec,
        _DTYPE_CODE[x.dtype], _stream_of(x)))
    BAND_LAUNCHES[name] += 1
    return stats


def instance_norm_band_apply(x: torch.Tensor, coef: torch.Tensor, relu: bool = False
                             ) -> torch.Tensor:
    """y = (x - mean) * rstd (ReLU) on the band, ``coef`` (B, C, 4) f32 the
    whole image's (mean, rstd, 1 / n, 0). CPU: plain; CUDA: one launch."""
    if x.device.type == "cpu":
        return instance_norm_band_apply_plain(x, coef, relu)
    name = "instance_norm_band_apply"
    _check_band(name, x)
    _check_small(name, "coef", coef, x, 4)
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    b, hw, c = x.shape
    cb, rl, splits, groups, vec = _band_geometry(name, x, _ITEMS, y)
    check(name, LIBRARY.load().hst_instance_norm_band_apply(
        x.data_ptr(), coef.data_ptr(), y.data_ptr(), b, hw, c, cb, rl, splits, groups, int(relu),
        vec, _DTYPE_CODE[x.dtype], _stream_of(x)))
    BAND_LAUNCHES[name] += 1
    return y


def instance_norm_band_bwd_reduce(x: torch.Tensor, dy: torch.Tensor, coef: torch.Tensor,
                                  relu: bool = False, y: Optional[torch.Tensor] = None
                                  ) -> torch.Tensor:
    """(B, C, 2) Σg and Σg·x̂ of the band (under ReLU the mask from the
    forward's y). CPU: plain; CUDA: per-block sums and their merge in block
    order (two launches, one count); an empty band launches nothing."""
    if x.device.type == "cpu":
        return instance_norm_band_bwd_reduce_plain(x, dy, coef, relu, y)
    name = "instance_norm_band_bwd_reduce"
    if relu and y is None:
        raise ValueError(f"{name}: relu needs the forward's output y for its mask")
    _check_band(name, x, dy, *((y,) if relu else ()))
    _check_small(name, "coef", coef, x, 4)
    b, hw, c = x.shape
    out = torch.zeros((b, c, 2), device=x.device, dtype=torch.float32)
    if b == 0 or hw == 0 or c == 0:
        return out
    cb, rl, splits, groups, vec = _band_geometry(name, x, _BWD_ITEMS, dy,
                                                 *((y,) if relu else ()))
    ws = torch.empty((b, splits, c, 2), device=x.device, dtype=torch.float32)
    check(name, LIBRARY.load().hst_instance_norm_band_bwd_reduce(
        x.data_ptr(), dy.data_ptr(), y.data_ptr() if relu else None, coef.data_ptr(),
        ws.data_ptr(), out.data_ptr(), b, hw, c, cb, rl, splits, groups, int(relu), vec,
        _DTYPE_CODE[x.dtype], _stream_of(x)))
    BAND_LAUNCHES[name] += 1
    return out


def instance_norm_band_bwd_apply(x: torch.Tensor, dy: torch.Tensor, coef: torch.Tensor,
                                 sums: torch.Tensor, relu: bool = False,
                                 y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dx of the band in x's dtype from the whole image's ``coef`` and
    ``sums`` (B, C, 2). CPU: plain; CUDA: one launch."""
    if x.device.type == "cpu":
        return instance_norm_band_bwd_apply_plain(x, dy, coef, sums, relu, y)
    name = "instance_norm_band_bwd_apply"
    if relu and y is None:
        raise ValueError(f"{name}: relu needs the forward's output y for its mask")
    _check_band(name, x, dy, *((y,) if relu else ()))
    _check_small(name, "coef", coef, x, 4)
    _check_small(name, "sums", sums, x, 2)
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    b, hw, c = x.shape
    cb, rl, splits, groups, vec = _band_geometry(name, x, _BWD_ITEMS, dy, dx,
                                                 *((y,) if relu else ()))
    check(name, LIBRARY.load().hst_instance_norm_band_bwd_apply(
        x.data_ptr(), dy.data_ptr(), y.data_ptr() if relu else None, coef.data_ptr(),
        sums.data_ptr(), dx.data_ptr(), b, hw, c, cb, rl, splits, groups, int(relu), vec,
        _DTYPE_CODE[x.dtype], _stream_of(x)))
    BAND_LAUNCHES[name] += 1
    return dx


# ------------------------------------------------------- torch.library ops
#
# As in ``gram.py``: each wrapper is an operator of the ``hst`` namespace
# (``_library.py``), and the forward's gradient is the backward op.


def _stat_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def _in_bwd_fake(x, dy, scale, bias, eps, relu, y):
    stats = x.new_empty((x.shape[0], x.shape[2]), dtype=_stat_dtype(x.dtype))
    return torch.empty_like(x), stats, torch.empty_like(stats)


def _in_setup(ctx, inputs, output):
    x, scale, bias, eps, relu = inputs
    ctx.eps, ctx.relu = eps, relu
    ctx.save_for_backward(x, scale, bias, output if relu else None)


def _in_grad(ctx, dy):
    x, scale, bias, y = ctx.saved_tensors
    dx, dscale, dbias = backward_op(ctx, INSTANCE_NORM_BWD, x, dy.contiguous(), scale, bias,
                                    ctx.eps, ctx.relu, y)
    return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


INSTANCE_NORM_BWD = define(
    "instance_norm_bwd(Tensor x, Tensor dy, Tensor scale, Tensor bias, float eps, bool relu, "
    "Tensor? y) -> (Tensor, Tensor, Tensor)",
    lambda *a: instance_norm_bwd(*a),
    _in_bwd_fake)
INSTANCE_NORM_FWD = define(
    "instance_norm_fwd(Tensor x, Tensor scale, Tensor bias, float eps, bool relu) -> Tensor",
    lambda *a: instance_norm_fwd(*a),
    lambda x, scale, bias, eps, relu: torch.empty_like(x), _in_setup, _in_grad)


def _small_fake(k: int):
    return lambda x, *rest: x.new_empty((x.shape[0], x.shape[2], k),
                                        dtype=_stat_dtype(x.dtype))


INSTANCE_NORM_BAND_STATS = define(
    "instance_norm_band_stats(Tensor x) -> Tensor",
    lambda *a: instance_norm_band_stats(*a), _small_fake(3))
INSTANCE_NORM_BAND_APPLY = define(
    "instance_norm_band_apply(Tensor x, Tensor coef, bool relu) -> Tensor",
    lambda *a: instance_norm_band_apply(*a), lambda x, coef, relu: torch.empty_like(x))
INSTANCE_NORM_BAND_BWD_REDUCE = define(
    "instance_norm_band_bwd_reduce(Tensor x, Tensor dy, Tensor coef, bool relu, Tensor? y) "
    "-> Tensor",
    lambda *a: instance_norm_band_bwd_reduce(*a), _small_fake(2))
INSTANCE_NORM_BAND_BWD_APPLY = define(
    "instance_norm_band_bwd_apply(Tensor x, Tensor dy, Tensor coef, Tensor sums, bool relu, "
    "Tensor? y) -> Tensor",
    lambda *a: instance_norm_band_bwd_apply(*a),
    lambda x, dy, coef, sums, relu, y: torch.empty_like(x))


class InstanceNormFunction:
    """``hst::instance_norm_fwd`` with ``hst::instance_norm_bwd`` as its
    gradient: apply(x (B, HW, C), scale, bias (B, C) f32, eps, relu). On
    CPU tensors both directions take the plain versions, so the CPU tests
    check the backward's formula itself. Under ReLU the output is saved for
    the backward's mask."""

    @staticmethod
    def apply(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = EPS,
              relu: bool = False) -> torch.Tensor:
        return call(INSTANCE_NORM_FWD, x, scale, bias, float(eps), bool(relu))
