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
from typing import Dict, List, Tuple

import torch

from ..pooling import adaptive_pool_matrix
from ._nvcc import CudaLibrary, check

KERNELS = ("gram_fwd", "gram_bwd", "pooled_gram_fwd")
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
_MAX_ROW_BYTES = 96 * 1024  # pooled_gram_fwd stages whole rows (PG_MAX_ROW_BYTES)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hst_gram_fwd.argtypes = [p, p, i, i, i, i, i, i, i, p]
    lib.hst_gram_bwd.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, p]
    lib.hst_pooled_gram_fwd.argtypes = [p, p, i, i, i, i, i, i, p]
    lib.hst_pooled_project.argtypes = [p, p, i, i, i, i, i, p]
    for fn in (lib.hst_gram_fwd, lib.hst_gram_bwd, lib.hst_pooled_gram_fwd,
               lib.hst_pooled_project):
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


def pooled_gram_fwd_plain(f: torch.Tensor, out_size: int) -> torch.Tensor:
    """(N, HW, C) -> (N, S, S) = (f P^T)^T (f P^T) / HW with P =
    ``adaptive_pool_matrix(C, S)``, P and the projection kept in f32 as the
    kernel keeps them."""
    acc = _acc_dtype(f.dtype)
    p = adaptive_pool_matrix(f.shape[-1], out_size, f.device)
    pf = torch.matmul(f.to(acc), p.to(acc).t())  # (N, HW, S)
    return (torch.bmm(pf.transpose(1, 2), pf) / f.shape[1]).to(f.dtype)


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
    the route that ``gram_fwd_plan_for`` picks from dtype, C and alignment."""
    if f.device.type == "cpu":
        return gram_fwd_plain(f)
    _check_input("gram_fwd", f)
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


def pooled_gram_fwd(f: torch.Tensor, out_size: int) -> torch.Tensor:
    """(N, HW, C) -> (N, S, S) with S = out_size, as
    ``pooled_gram_pallas(x, out_size)``. CPU: plain; CUDA: the kernels,
    which compute the pooling bins themselves, on the route that
    ``pooled_gram_route_for`` names (one call counts one launch). Forward
    only: there is no backward kernel yet, so a CUDA input that needs a
    gradient raises."""
    if f.device.type == "cpu":
        return pooled_gram_fwd_plain(f, out_size)
    _check_input("pooled_gram_fwd", f)
    if torch.is_grad_enabled() and f.requires_grad:
        raise NotImplementedError("pooled_gram_fwd has no backward kernel yet")
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
        return g.to(f.dtype)
    splits, _ = _pooled_gram_plan(n, hw, _sm_count(f.device))
    g = torch.empty((n, s, s), device=f.device, dtype=f.dtype)
    err = lib.hst_pooled_gram_fwd(
        f.data_ptr(), g.data_ptr(), n, hw, c, s, splits, _DTYPE_CODE[f.dtype], stream,
    )
    check("pooled_gram_fwd", err)
    LAUNCHES["pooled_gram_fwd"] += 1
    return g


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
