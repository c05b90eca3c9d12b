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
from typing import Dict

import torch

from ._nvcc import CudaLibrary, check

KERNELS = ("gram_fwd", "gram_bwd", "pooled_gram_fwd")
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE = 64  # gram_fwd output tile edge (csrc/gram.cu TILE)
_BK = 16  # gram_fwd rows per shared-memory stage (csrc/gram.cu BK)
_PG_WARPS = 8  # pooled_gram_fwd warps per block (csrc/gram.cu PG_WARPS)
MAX_POOL_SIZE = 16  # csrc/gram.cu MAX_S
_MAX_SMEM = 200 * 1024  # dynamic shared memory left for P (S x C f32)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hst_gram_fwd.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.hst_gram_bwd.argtypes = [p, p, p, i, i, i, i, p]
    lib.hst_pooled_gram_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, p]
    for fn in (lib.hst_gram_fwd, lib.hst_gram_bwd, lib.hst_pooled_gram_fwd):
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


def pooled_gram_fwd_plain(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, HW, C), P (S, C) f32 -> (N, S, S) = (f P^T)^T (f P^T) / HW with
    P and the projection kept in f32, as the kernel keeps them."""
    acc = _acc_dtype(f.dtype)
    pf = torch.matmul(f.to(acc), p.to(acc).t())  # (N, HW, S)
    return (torch.bmm(pf.transpose(1, 2), pf) / f.shape[1]).to(f.dtype)


# ------------------------------------------------------------------ kernels


def gram_fwd(f: torch.Tensor) -> torch.Tensor:
    """(N, HW, C) -> (N, C, C). CPU: plain version; CUDA: the kernel."""
    if f.device.type == "cpu":
        return gram_fwd_plain(f)
    _check_input("gram_fwd", f)
    n, hw, c = f.shape
    g = torch.empty((n, c, c), device=f.device, dtype=f.dtype)
    blocks = math.ceil(c / _TILE) ** 2 * n
    splits = 1
    sms = _sm_count(f.device)
    if blocks < sms:  # too few tiles to fill the SMs: split HW, reduce after
        splits = max(1, min(math.ceil(2 * sms / blocks), hw // 128))
    rows = math.ceil(math.ceil(hw / splits) / _BK) * _BK
    splits = math.ceil(hw / rows)
    ws = (torch.empty((n, splits, c, c), device=f.device, dtype=torch.float32)
          if splits > 1 else None)
    err = LIBRARY.load().hst_gram_fwd(
        f.data_ptr(), g.data_ptr(), ws.data_ptr() if ws is not None else None,
        n, hw, c, splits, rows, _DTYPE_CODE[f.dtype], _stream(f.device),
    )
    check("gram_fwd", err)
    LAUNCHES["gram_fwd"] += 1
    return g


def gram_bwd(f: torch.Tensor, dg: torch.Tensor) -> torch.Tensor:
    """dF (N, HW, C) from f and dG (N, C, C). CPU: plain; CUDA: the kernel."""
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
    err = LIBRARY.load().hst_gram_bwd(
        f.data_ptr(), dg.data_ptr(), df.data_ptr(), n, hw, c,
        _DTYPE_CODE[f.dtype], _stream(f.device),
    )
    check("gram_bwd", err)
    LAUNCHES["gram_bwd"] += 1
    return df


def pooled_gram_fwd(f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """(N, HW, C), P (S, C) f32 -> (N, S, S). CPU: plain; CUDA: the kernel.
    Forward only: the kernel has no backward yet, so a CUDA input that
    needs a gradient raises."""
    if f.device.type == "cpu":
        return pooled_gram_fwd_plain(f, p)
    _check_input("pooled_gram_fwd", f)
    if torch.is_grad_enabled() and f.requires_grad:
        raise NotImplementedError("pooled_gram_fwd has no backward kernel yet")
    n, hw, c = f.shape
    s = p.shape[0]
    if p.device != f.device or p.dtype != torch.float32 or tuple(p.shape) != (s, c):
        raise ValueError(f"pooled_gram_fwd: P must be (S, {c}) float32 on {f.device}")
    if not p.is_contiguous():
        raise ValueError("pooled_gram_fwd: P is not contiguous")
    if s > MAX_POOL_SIZE or s * c * 4 > _MAX_SMEM:
        raise ValueError(
            f"pooled_gram_fwd: S={s}, C={c} exceeds the kernel's limits "
            f"(S <= {MAX_POOL_SIZE}, S*C*4 <= {_MAX_SMEM} bytes)"
        )
    g = torch.empty((n, s, s), device=f.device, dtype=f.dtype)
    # enough blocks for two waves over the SMs, at least one row per warp
    splits = max(1, min(math.ceil(hw / _PG_WARPS), math.ceil(2 * _sm_count(f.device) / n)))
    rows = math.ceil(hw / splits)
    splits = math.ceil(hw / rows)
    ws = (torch.empty((n, splits, s, s), device=f.device, dtype=torch.float32)
          if splits > 1 else None)
    err = LIBRARY.load().hst_pooled_gram_fwd(
        f.data_ptr(), p.data_ptr(), g.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        n, hw, c, s, splits, rows, _DTYPE_CODE[f.dtype], _stream(f.device),
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
