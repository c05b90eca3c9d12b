"""Wrappers of the hand-written Gram kernels (csrc/gram.cu), their plain
PyTorch versions and their launch counts.

Every wrapper takes the (N, HW, C) view of an NHWC activation. A tensor on
the CPU goes through the plain version (the CPU tests and the parity checks
use it); a CUDA tensor launches the kernel or raises — there is no fallback.
``LAUNCHES[name]`` counts kernel launches only, so a run can show that its
main path went through the kernels.

The kernels are compiled on first use with ``nvcc`` into a shared library
under ``_build/`` of this package and bound with ``ctypes`` (``_nvcc.py``).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from ..pooling import adaptive_pool_matrix
from ._nvcc import CudaLibrary, check

KERNELS = ("gram_fwd", "gram_bwd", "pooled_gram_fwd", "pooled_gram_bwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE_CODE = {"ffma": 0, "wgmma": 1}
_TILE = 64  # gram_fwd output tile edge (csrc/gram.cu TILE)
_FFMA_STAGE_ROWS = 16  # csrc/gram.cu BK
_MAX_SPLITS = 16  # csrc/gram.cu MAX_SPLITS: one cluster per tile
_MIN_SPLIT_ROWS = 128  # gram_fwd splits HW no finer than this
_BWD_STAGE_K = {"ffma": 16, "wgmma": 64}  # gram_bwd channels a stage (BWD_BK, TILE)
_MIN_SPLIT_K = 256  # gram_bwd splits C no finer than this
_BWD_BLOCKS_PER_SM = {"ffma": 3, "wgmma": 2}  # gram_bwd blocks an SM holds
MAX_POOL_SIZE = 16  # csrc/gram.cu MAX_S: larger S takes the "project" route
MAX_POOL_BWD_SIZE = 64  # csrc/gram.cu PGB_MAX_S: pooled_gram_bwd's largest S
_PGB_SLOTS, _PGB_MAX_ROWS = 3, 64  # csrc/gram.cu PGB_SLOTS, PGB_MAX_ROWS
_PGB_MODE_CODE = {"scalar": 0, "bulk": 1}  # csrc/gram.cu PgbMode
_PGB_TILE_BYTES = 32 * 1024  # dF a pooled_gram_bwd tile aims at
_PGB_BLOCKS_PER_SM = 4  # its __launch_bounds__ minimum
_PGB_STATIC_SMEM = 3 * MAX_POOL_BWD_SIZE * 4  # lo, hi, w
_SMEM_BLOCK, _SMEM_SM, _SMEM_RESERVED = 227 * 1024, 228 * 1024, 1024  # H100 SXM
_MAX_ROW_BYTES = 96 * 1024  # pooled_gram_fwd stages whole rows (PG_MAX_ROW_BYTES)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hst_gram_fwd.argtypes = [p, p, i, i, i, i, i, i, i, p]
    lib.hst_gram_bwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.hst_pooled_gram_fwd.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.hst_pooled_project.argtypes = [p, p, i, i, i, i, i, p]
    lib.hst_pooled_gram_bwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p]
    for fn in (lib.hst_gram_fwd, lib.hst_gram_bwd, lib.hst_pooled_gram_fwd,
               lib.hst_pooled_project, lib.hst_pooled_gram_bwd):
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("gram", _bind)


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def _check_input(name: str, f: torch.Tensor) -> None:
    if f.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {f.device}")
    if f.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {f.dtype} not supported (float32 or bfloat16)")
    if f.dim() != 3:
        raise ValueError(f"{name}: expected (N, HW, C), got shape {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError(
            f"{name}: (N, HW, C) input is not contiguous (strides {f.stride()}); "
            "keep activations in channels_last so the NHWC view needs no copy"
        )


def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ----------------------------------------------------------- plain versions


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def gram_fwd_plain(f: torch.Tensor) -> torch.Tensor:
    """(N, HW, C) -> (N, C, C) = f^T f / HW, summed in f32, cast back once."""
    fa = f.to(_acc_dtype(f.dtype))
    return (torch.bmm(fa.transpose(1, 2), fa) / f.shape[1]).to(f.dtype)


def gram_bwd_plain(f: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """dF = f (dG + dG^T) / HW, summed in f32, cast back to f's dtype."""
    acc = _acc_dtype(f.dtype)
    dga = dg.to(acc)
    return (torch.bmm(f.to(acc), dga + dga.transpose(1, 2)) / f.shape[1]).to(f.dtype)


def pooled_gram_y_plain(f: torch.Tensor, out_size: int) -> torch.Tensor:
    """Y = f P^T (N, HW, S) with P = ``adaptive_pool_matrix(C, S)`` in f32,
    summed in f32 (f64 stays f64): the bin means that the pooled Gram is
    made of and that its backward reads (JAX's ``pf``, ops/gram.py:73)."""
    acc = _acc_dtype(f.dtype)
    p = adaptive_pool_matrix(f.shape[-1], out_size, f.device)
    return torch.matmul(f.to(acc), p.to(acc).t())


def _pooled_gram_of_y(y: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (torch.bmm(y.transpose(1, 2), y) / y.shape[1]).to(dtype)


def pooled_gram_fwd_plain(f: torch.Tensor, out_size: int) -> torch.Tensor:
    """(N, HW, C) -> (N, S, S) = Y^T Y / HW with Y = ``pooled_gram_y_plain``,
    P and the projection kept in f32 as the kernel keeps them."""
    return _pooled_gram_of_y(pooled_gram_y_plain(f, out_size), f.dtype)


def pooled_gram_bwd_plain(y: torch.Tensor, dg: torch.Tensor, channels: int,
                          dtype: torch.dtype) -> torch.Tensor:
    """The VJP of ``pooled_gram_fwd_plain`` from the forward's Y (N, HW, S):
    with M = (dG + dG^T) / HW, dF = (Y M) P in Y's dtype (f32, or f64), P =
    ``adaptive_pool_matrix(channels, S)`` in f32, cast to ``dtype`` once."""
    acc = y.dtype
    p = adaptive_pool_matrix(channels, y.shape[-1], y.device).to(acc)
    dga = dg.to(acc)
    m = (dga + dga.transpose(1, 2)) / y.shape[1]
    return torch.matmul(torch.bmm(y, m), p).to(dtype)


# ------------------------------------------------------------------ kernels


def _gram_fwd_plan(n: int, hw: int, c: int, sms: int, dtype: torch.dtype,
                   aligned: bool = True) -> Tuple[str, int, int, int]:
    """How ``gram_fwd`` launches on an (n, hw, c) input: (route, tiles,
    splits, rows_per_split).

    route: "wgmma" for bf16 with C % 8 == 0 on a 16-byte-aligned pointer
    (TMA needs 16-byte strides), else "ffma". tiles: the 64x64 tiles
    (bi <= bj) of one image's upper triangle, numbered as
    ``_triangle_tile``. splits: a power of two up to 16, the blocks of one
    tile's cluster; HW is split until the blocks reach the SM count (wgmma,
    whose blocks fit two to an SM) or twice it (ffma), keeping at least 128
    rows a split. ``_split_rows`` gives each split's rows: rows_per_split
    each, a whole number of the route's stages (csrc/gram.cu BK, KROWS), and
    the last split the rest of HW."""
    route = "wgmma" if dtype == torch.bfloat16 and c % 8 == 0 and aligned else "ffma"
    side = -(-c // _TILE)
    tiles = side * (side + 1) // 2
    waves = 1 if route == "wgmma" else 2
    splits = 1
    while (splits < _MAX_SPLITS and tiles * n * splits < waves * sms
           and hw // (2 * splits) >= _MIN_SPLIT_ROWS):
        splits *= 2
    step = _FFMA_STAGE_ROWS if route == "ffma" else (64 if hw <= 64 else 128)
    # round each split's share up or down to whole stages, whichever leaves
    # the longest split (the last takes the rest) shortest
    share = hw / splits
    up = math.ceil(share / step) * step
    down = max(step, math.floor(share / step) * step) if splits > 1 else up
    rows = min((up, down), key=lambda r: (max(r, hw - (splits - 1) * r), r))
    return route, tiles, splits, rows


def _split_rows(hw: int, splits: int, rows: int) -> List[Tuple[int, int]]:
    """[begin, end) of HW rows for each split, as the kernels take them:
    rows each, the last split the rest (empty where HW ends earlier)."""
    out = []
    for s in range(splits):
        begin = min(hw, s * rows)
        end = hw if s == splits - 1 else min(hw, begin + rows)
        out.append((begin, end))
    return out


def _triangle_tile(t: int) -> Tuple[int, int]:
    """(bi, bj), bi <= bj, of upper-triangle tile t = bj (bj + 1) / 2 + bi,
    as csrc/gram.cu ``tri_tile`` numbers the blocks."""
    bj = (math.isqrt(8 * t + 1) - 1) // 2
    return t - bj * (bj + 1) // 2, bj


def gram_fwd_plan_for(f: torch.Tensor) -> Tuple[str, int, int, int]:
    """``_gram_fwd_plan`` for a CUDA (N, HW, C) tensor."""
    n, hw, c = f.shape
    return _gram_fwd_plan(n, hw, c, _sm_count(f.device), f.dtype,
                          aligned=f.data_ptr() % 16 == 0)


def gram_fwd(f: torch.Tensor) -> torch.Tensor:
    """(N, HW, C) -> (N, C, C). CPU: plain version; CUDA: the kernel, on
    the route that ``gram_fwd_plan_for`` picks from dtype, C and alignment.
    The kernel's output has no autograd graph, so a CUDA input that needs a
    gradient raises: ``GramFunction`` is the differentiable Gram."""
    if f.device.type == "cpu":
        return gram_fwd_plain(f)
    _check_input("gram_fwd", f)
    if torch.is_grad_enabled() and f.requires_grad:
        raise NotImplementedError("gram_fwd is forward only: call GramFunction.apply for a "
                                  "Gram that needs a gradient (its backward is gram_bwd)")
    n, hw, c = f.shape
    route, _, splits, rows = gram_fwd_plan_for(f)
    g = torch.empty((n, c, c), device=f.device, dtype=f.dtype)
    err = LIBRARY.load().hst_gram_fwd(
        f.data_ptr(), g.data_ptr(), n, hw, c, splits, rows, _ROUTE_CODE[route],
        _DTYPE_CODE[f.dtype], _stream(f.device),
    )
    check("gram_fwd", err)
    LAUNCHES["gram_fwd"] += 1
    return g


def _bwd_col_tile(route: str, row_tile: int) -> int:
    """Columns of dF a ``gram_bwd`` block covers: on ffma the 64 x 128 tile
    or the 128 x 64 one; on wgmma square tiles, 64 x 64 or 128 x 128."""
    if route == "ffma":
        return 128 if row_tile == 64 else 64
    return row_tile


def _gram_bwd_plan(n: int, hw: int, c: int, sms: int, dtype: torch.dtype,
                   aligned: bool = True) -> Tuple[str, int, int, int, int]:
    """How ``gram_bwd`` launches on an (n, hw, c) input: (route, row_tile,
    col_tiles, k_splits, k_per_split).

    route: "wgmma" for bf16 with C % 8 == 0 on 16-byte-aligned F, dG and dF,
    else "ffma". row_tile: ffma takes 64 x 128 tiles (64 rows) where HW <=
    64 or C > 64, else 128 x 64; wgmma takes 128 x 128 tiles where HW > 64,
    C % 128 == 0 (no column tile lies wholly past C) and such tiles still
    give every SM a block, else 64 x 64. col_tiles: of
    ``_bwd_col_tile`` columns each. k_splits: a power of two up to 16, the
    blocks of one tile's cluster; C is split until the blocks fill the
    slots the SMs hold at once (3 an SM on ffma, 2 on wgmma), keeping at
    least 256 channels a split. ``_k_ranges`` gives each split's channels:
    k_per_split each, a whole number of the route's stages, the last the
    rest of C."""
    route = "wgmma" if dtype == torch.bfloat16 and c % 8 == 0 and aligned else "ffma"
    if route == "ffma":
        row_tile = 64 if hw <= 64 or c > 64 else 128
    else:
        big = hw > 64 and c % 128 == 0 and n * -(-hw // 128) * (c // 128) >= sms
        row_tile = 128 if big else 64
    col_tiles = -(-c // _bwd_col_tile(route, row_tile))
    blocks = n * -(-hw // row_tile) * col_tiles
    k_splits = 1
    while (k_splits < _MAX_SPLITS and blocks * k_splits < _BWD_BLOCKS_PER_SM[route] * sms
           and c // (2 * k_splits) >= _MIN_SPLIT_K):
        k_splits *= 2
    step = _BWD_STAGE_K[route]
    share = -(-c // k_splits)
    return route, row_tile, col_tiles, k_splits, -(-share // step) * step


def _k_ranges(c: int, k_splits: int, k_per_split: int) -> List[Tuple[int, int]]:
    """[begin, end) of channels for each split, as ``gram_bwd`` takes them
    (csrc/gram.cu ``k_range``): k_per_split each, the last the rest."""
    out = []
    for s in range(k_splits):
        begin = min(c, s * k_per_split)
        out.append((begin, c if s == k_splits - 1 else min(c, begin + k_per_split)))
    return out


def gram_bwd_plan_for(f: torch.Tensor, dg: torch.Tensor,
                      df: torch.Tensor) -> Tuple[str, int, int, int, int]:
    """``_gram_bwd_plan`` for CUDA tensors F, dG and dF."""
    n, hw, c = f.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (f, dg, df))
    return _gram_bwd_plan(n, hw, c, _sm_count(f.device), f.dtype, aligned=aligned)


def gram_bwd(f: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """dF (N, HW, C) from f and dG (N, C, C). CPU: plain; CUDA: the kernel,
    on the route and splits that ``gram_bwd_plan_for`` picks."""
    if f.device.type == "cpu":
        return gram_bwd_plain(f, dg)
    _check_input("gram_bwd", f)
    n, hw, c = f.shape
    if dg.device != f.device or dg.dtype != f.dtype or tuple(dg.shape) != (n, c, c):
        raise ValueError(
            f"gram_bwd: dG must be ({n}, {c}, {c}) {f.dtype} on {f.device}, "
            f"got {tuple(dg.shape)} {dg.dtype} on {dg.device}"
        )
    if not dg.is_contiguous():
        raise ValueError("gram_bwd: dG is not contiguous")
    df = torch.empty_like(f)
    route, row_tile, _, k_splits, k_per_split = gram_bwd_plan_for(f, dg, df)
    err = LIBRARY.load().hst_gram_bwd(
        f.data_ptr(), dg.data_ptr(), df.data_ptr(), n, hw, c, _ROUTE_CODE[route], row_tile,
        _bwd_col_tile(route, row_tile), k_splits, k_per_split, _DTYPE_CODE[f.dtype],
        _stream(f.device),
    )
    check("gram_bwd", err)
    LAUNCHES["gram_bwd"] += 1
    return df


def _pool_bins(c: int, s: int) -> List[Tuple[int, int, float]]:
    """(start, end, weight) of each adaptive-pooling bin over C channels, as
    ``pooled_gram_kernel`` computes them: [floor(o C / S), ceil((o + 1) C /
    S)) and the f32 weight 1 / len, the support and values of row o of
    ``adaptive_pool_matrix(C, S)``."""
    bins = []
    for o in range(s):
        lo, hi = o * c // s, ((o + 1) * c + s - 1) // s
        bins.append((lo, hi, (torch.ones((), dtype=torch.float32) / (hi - lo)).item()))
    return bins


def _pooled_gram_plan(n: int, hw: int, sms: int) -> Tuple[int, int]:
    """How ``pooled_gram_fwd`` splits HW: (splits, rows_per_split). splits:
    a power of two up to 16, the blocks of one image's cluster, doubled
    while N x splits is short of the SM count and every split keeps a row;
    ``_pooled_split_rows`` gives each split's rows, rows_per_split at most."""
    splits = 1
    while splits < _MAX_SPLITS and 2 * splits <= hw and n * splits < sms:
        splits *= 2
    return splits, -(-hw // splits)


def _pooled_split_rows(hw: int, splits: int) -> List[Tuple[int, int]]:
    """[begin, end) of HW rows for each split, as the kernel takes them:
    HW // splits rows each, one more for the first HW % splits splits."""
    base, extra = divmod(hw, splits)
    out = []
    for i in range(splits):
        begin = i * base + min(i, extra)
        out.append((begin, begin + base + (1 if i < extra else 0)))
    return out


def _pooled_gram_route(dtype: torch.dtype, c: int, s: int, aligned: bool = True) -> str:
    """How ``pooled_gram_fwd`` runs, as the wrapper and csrc/gram.cu pick it:
    for S <= ``MAX_POOL_SIZE`` one ``pooled_gram_kernel`` that stages F by
    "bulk" (one TMA bulk copy a stage: C * size a multiple of 16 bytes on a
    16-byte-aligned F) or by "scalar" loads; for larger S "project":
    ``pooled_project_kernel`` writes Y = F P^T in f32, then gram_fwd's FFMA
    route computes Y^T Y / HW."""
    if s > MAX_POOL_SIZE:
        return "project"
    return "bulk" if aligned and c * (2 if dtype == torch.bfloat16 else 4) % 16 == 0 else "scalar"


def pooled_gram_route_for(f: torch.Tensor, s: int) -> str:
    """``_pooled_gram_route`` for a CUDA (N, HW, C) tensor."""
    return _pooled_gram_route(f.dtype, f.shape[-1], s, aligned=f.data_ptr() % 16 == 0)


def pooled_gram_fwd(f: torch.Tensor, out_size: int, return_y: bool = False):
    """(N, HW, C) -> (N, S, S) with S = out_size, as
    ``pooled_gram_pallas(x, out_size)``. CPU: plain; CUDA: the kernels,
    which compute the pooling bins themselves, on the route that
    ``pooled_gram_route_for`` names (one call counts one launch). The
    kernels' output has no autograd graph, so a CUDA input that needs a
    gradient raises: ``PooledGramFunction`` is the differentiable pooled
    Gram (its backward is ``pooled_gram_bwd``). ``return_y``: also return
    the bin means Y = f P^T (N, HW, S), f32 (f64 for f64), that G was made
    of, which ``pooled_gram_bwd`` takes."""
    if f.device.type == "cpu":
        y = pooled_gram_y_plain(f, out_size)
        g = _pooled_gram_of_y(y, f.dtype)
        return (g, y) if return_y else g
    _check_input("pooled_gram_fwd", f)
    if torch.is_grad_enabled() and f.requires_grad:
        raise NotImplementedError(
            "pooled_gram_fwd is forward only: call PooledGramFunction.apply for a pooled Gram "
            "that needs a gradient (its backward is pooled_gram_bwd)")
    n, hw, c = f.shape
    s = int(out_size)
    project = s > MAX_POOL_SIZE
    if s < 1 or hw < 1 or (not project and c * f.element_size() > _MAX_ROW_BYTES):
        raise ValueError(
            f"pooled_gram_fwd: S={s}, HW={hw}, C={c} outside the kernels' limits "
            f"(S >= 1, HW >= 1; for S <= {MAX_POOL_SIZE} a row of F <= {_MAX_ROW_BYTES} bytes)"
        )
    lib, stream = LIBRARY.load(), _stream(f.device)
    if project:
        y = torch.empty((n, hw, s), device=f.device, dtype=torch.float32)
        check("pooled_gram_fwd", lib.hst_pooled_project(
            f.data_ptr(), y.data_ptr(), n, hw, c, s, _DTYPE_CODE[f.dtype], stream))
        route, _, splits, rows = _gram_fwd_plan(n, hw, s, _sm_count(f.device), torch.float32)
        g = torch.empty((n, s, s), device=f.device, dtype=torch.float32)
        check("pooled_gram_fwd", lib.hst_gram_fwd(
            y.data_ptr(), g.data_ptr(), n, hw, s, splits, rows, _ROUTE_CODE[route],
            _DTYPE_CODE[torch.float32], stream))
        LAUNCHES["pooled_gram_fwd"] += 1
        return (g.to(f.dtype), y) if return_y else g.to(f.dtype)
    splits, _ = _pooled_gram_plan(n, hw, _sm_count(f.device))
    g = torch.empty((n, s, s), device=f.device, dtype=f.dtype)
    y = torch.empty((n, hw, s), device=f.device, dtype=torch.float32) if return_y else None
    err = lib.hst_pooled_gram_fwd(
        f.data_ptr(), g.data_ptr(), None if y is None else y.data_ptr(), n, hw, c, s, splits,
        _DTYPE_CODE[f.dtype], stream,
    )
    check("pooled_gram_fwd", err)
    LAUNCHES["pooled_gram_fwd"] += 1
    return (g, y) if return_y else g


class PgbPlan(NamedTuple):
    """How ``pooled_gram_bwd`` launches: mode ("bulk" or "scalar",
    csrc/gram.cu PgbMode), tile_rows (rows of one image a tile),
    blocks (the persistent grid), smem (dynamic shared memory a block)."""
    mode: str
    tile_rows: int
    blocks: int
    smem: int


def _pgb_smem(mode: str, c: int, s: int, tile_rows: int, es: int) -> int:
    """csrc/gram.cu ``pgb_smem``: [bulk: two staged dF tiles] [the Y ring of
    _PGB_SLOTS tiles] [z] [M] [the group table, 2 bytes a group]."""
    v = 16 // es
    staged = 2 * tile_rows * c * es if mode == "bulk" else 0
    return staged + 4 * ((_PGB_SLOTS + 1) * tile_rows * s + s * s) + 2 * -(-c // v)


def _pooled_gram_bwd_plan(n: int, hw: int, c: int, s: int, es: int, sms: int,
                          tile_bytes: int = _PGB_TILE_BYTES,
                          blocks_per_sm: int = _PGB_BLOCKS_PER_SM) -> PgbPlan:
    """How ``pooled_gram_bwd`` runs on Y (n, hw, s) into dF (n, hw, c) of
    element size es (a fresh, 16-byte-aligned tensor). mode: "bulk" where
    C is a whole number of 16-byte groups and two staged tiles fit in
    shared memory (a dF row up to about 110 KB); otherwise "scalar".
    tile_rows: the rows whose dF fills tile_bytes, 1 to _PGB_MAX_ROWS, and
    no more than a block's share of the rows. blocks: as many as the SMs
    hold at once, blocks_per_sm each where shared memory allows, and no
    more than the tiles; ``_pgb_tiles`` gives each block's rows. The
    defaults are what tools/pooled_gram_bwd_sweep.py found fastest at the
    b32 stage shapes."""
    vec = c * es % 16 == 0
    tile_rows = max(1, min(_PGB_MAX_ROWS, tile_bytes // (c * es)))
    fits = _pgb_smem("bulk", c, s, tile_rows, es) + _PGB_STATIC_SMEM <= _SMEM_BLOCK
    mode = "bulk" if vec and fits else "scalar"
    per_sm = max(1, min(blocks_per_sm, _SMEM_SM // (
        _pgb_smem(mode, c, s, tile_rows, es) + _PGB_STATIC_SMEM + _SMEM_RESERVED)))
    tile_rows = min(tile_rows, -(-n * hw // (sms * per_sm)))
    tiles = n * -(-hw // tile_rows)
    return PgbPlan(mode, tile_rows, min(sms * per_sm, tiles), _pgb_smem(mode, c, s, tile_rows, es))


def _pgb_tiles(n: int, hw: int, tile_rows: int, blocks: int) -> List[List[Tuple[int, int, int]]]:
    """(image, first row, end row) of each tile of each block, as
    ``pooled_gram_bwd_kernel`` walks them: block b takes the rows [b R / B,
    (b + 1) R / B) of all R = n hw rows, in tiles of at most tile_rows rows
    that never cross an image."""
    total = n * hw
    out = []
    for b in range(blocks):
        cur, end, tiles = total * b // blocks, total * (b + 1) // blocks, []
        while cur < end:
            image = cur // hw
            nxt = min(cur + tile_rows, end, (image + 1) * hw)
            tiles.append((image, cur - image * hw, nxt - image * hw))
            cur = nxt
        out.append(tiles)
    return out


def _pgb_group_bins(c: int, s: int, es: int) -> List[Tuple[int, int]]:
    """(first bin, bins) of each 16-byte group of a dF row, as the kernel's
    table holds them: the first bin whose end lies past the group's first
    channel, and the count of bins from it that start before the group's
    end."""
    v = 16 // es
    bins = _pool_bins(c, s)
    out = []
    for c0 in range(0, c, v):
        c1 = min(c0 + v, c)
        o0 = next(o for o, (_, hi, _) in enumerate(bins) if hi > c0)
        o1 = o0
        while o1 + 1 < s and bins[o1 + 1][0] < c1:
            o1 += 1
        out.append((o0, o1 - o0 + 1))
    return out


def pooled_gram_bwd_plan_for(y: torch.Tensor, channels: int, dtype: torch.dtype,
                             **choices) -> PgbPlan:
    """``_pooled_gram_bwd_plan`` for a CUDA Y and a fresh dF of ``dtype``
    (``torch.empty``: 16-byte aligned); ``choices`` force tile_bytes or
    blocks_per_sm, for measurements."""
    n, hw, s = y.shape
    es = torch.tensor([], dtype=dtype).element_size()
    return _pooled_gram_bwd_plan(n, hw, channels, s, es, _sm_count(y.device), **choices)


def pooled_gram_bwd(y: torch.Tensor, dg: torch.Tensor, channels: int, dtype: torch.dtype,
                    *, _plan: Optional[PgbPlan] = None) -> torch.Tensor:
    """dF (N, HW, C) of ``dtype``, the VJP of ``pooled_gram_fwd``, from the
    forward's Y = f P^T (N, HW, S) and dG (N, S, S) of ``dtype``; C =
    ``channels``. CPU: plain; CUDA: the kernel, one launch as
    ``pooled_gram_bwd_plan_for`` plans it (``_plan`` forces one, for
    measurements), for Y in f32 and any S up to ``MAX_POOL_BWD_SIZE``;
    beyond it raises. F is not needed."""
    if y.device.type == "cpu":
        return pooled_gram_bwd_plain(y, dg, channels, dtype)
    if y.device.type != "cuda":
        raise ValueError(f"pooled_gram_bwd: expected a CUDA tensor, got {y.device}")
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"pooled_gram_bwd: dtype {dtype} not supported (float32 or bfloat16)")
    if y.dtype != torch.float32 or y.dim() != 3 or not y.is_contiguous():
        raise ValueError(f"pooled_gram_bwd: Y must be a contiguous (N, HW, S) float32 tensor, "
                         f"got {tuple(y.shape)} {y.dtype} (contiguous: {y.is_contiguous()})")
    n, hw, s = y.shape
    c = int(channels)
    if not 1 <= s <= MAX_POOL_BWD_SIZE or hw < 1 or c < 1:
        raise ValueError(f"pooled_gram_bwd: S={s}, HW={hw}, C={c} outside the kernel's limits "
                         f"(1 <= S <= {MAX_POOL_BWD_SIZE}, HW >= 1, C >= 1)")
    if dg.device != y.device or dg.dtype != dtype or tuple(dg.shape) != (n, s, s):
        raise ValueError(
            f"pooled_gram_bwd: dG must be ({n}, {s}, {s}) {dtype} on {y.device}, "
            f"got {tuple(dg.shape)} {dg.dtype} on {dg.device}"
        )
    if not dg.is_contiguous():
        raise ValueError("pooled_gram_bwd: dG is not contiguous")
    df = torch.empty((n, hw, c), device=y.device, dtype=dtype)
    plan = _plan or pooled_gram_bwd_plan_for(y, c, dtype)
    if plan.smem > _SMEM_BLOCK - _PGB_STATIC_SMEM:
        raise ValueError(f"pooled_gram_bwd: C={c}, S={s} need {plan.smem} bytes of shared "
                         f"memory a block, more than the card's {_SMEM_BLOCK}")
    err = LIBRARY.load().hst_pooled_gram_bwd(
        y.data_ptr(), dg.data_ptr(), df.data_ptr(), n, hw, c, s, _PGB_MODE_CODE[plan.mode],
        plan.tile_rows, plan.blocks, _DTYPE_CODE[dtype], _stream(y.device),
    )
    check("pooled_gram_bwd", err)
    LAUNCHES["pooled_gram_bwd"] += 1
    return df


class PooledGramFunction(torch.autograd.Function):
    """G = Y^T Y / HW, Y = f P^T, with the hand-written backward
    (``pooled_gram_bwd``). Where f needs a gradient the forward also hands
    over Y (N, HW, S), f32, and that is all it saves: f is not kept, and
    the backward never reads it. Otherwise no Y is written. On CPU tensors
    both directions take the plain formulas."""

    @staticmethod
    def forward(ctx, f, out_size):
        ctx.channels, ctx.f_dtype = f.shape[-1], f.dtype
        if not ctx.needs_input_grad[0]:
            return pooled_gram_fwd(f, out_size)
        g, y = pooled_gram_fwd(f, out_size, return_y=True)
        ctx.save_for_backward(y)
        return g

    @staticmethod
    def backward(ctx, dg):
        (y,) = ctx.saved_tensors
        return pooled_gram_bwd(y, dg.contiguous(), ctx.channels, ctx.f_dtype), None


class GramFunction(torch.autograd.Function):
    """G = f^T f / HW with the hand-written backward. On CPU tensors both
    directions take the plain formulas, so the CPU tests check the backward
    formula itself."""

    @staticmethod
    def forward(ctx, f):
        ctx.save_for_backward(f)
        return gram_fwd(f)

    @staticmethod
    def backward(ctx, dg):
        (f,) = ctx.saved_tensors
        return gram_bwd(f, dg.contiguous())
