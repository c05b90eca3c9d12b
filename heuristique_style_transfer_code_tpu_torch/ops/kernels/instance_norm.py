"""Wrapper of the hand-written instance-norm kernel (csrc/instance_norm.cu),
its plain PyTorch version and its launch count.

The wrapper takes the (B, HW, C) view of an NHWC activation and per-image
(B, C) float32 scale and bias rows. A tensor on the CPU goes through the
plain version; a CUDA tensor launches the kernel or raises — there is no
fallback. The kernel is forward only, as the TPU kernel it replaces was, so
a CUDA input that needs a gradient raises. ``LAUNCHES["instance_norm_fwd"]``
counts kernel launches only.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from ._nvcc import CudaLibrary, check

KERNELS = ("instance_norm_fwd",)
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
EPS = 1e-5

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256  # csrc/instance_norm.cu THREADS
_ITEMS = 8  # csrc/instance_norm.cu ITEMS
_MAX_GRID_YZ = 65535


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hst_instance_norm_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                          ctypes.c_float, i, i, i, p]
    lib.hst_instance_norm_fwd.restype = ctypes.c_int


LIBRARY = CudaLibrary("instance_norm", _bind)


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


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


def _geometry(c: int, hw: int, vec_width: int):
    """Block geometry of csrc/instance_norm.cu for C channels read
    ``vec_width`` at a time: (cb, rl, splits, groups) — vector columns and
    row lanes per block, blocks along HW and along C."""
    cv = c // vec_width
    cb = min(cv, _THREADS)
    rl = _THREADS // cb
    splits = math.ceil(hw / (rl * _ITEMS))
    groups = math.ceil(cv / cb)
    return cb, rl, splits, groups


def instance_norm_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                      eps: float = EPS, relu: bool = False) -> torch.Tensor:
    """(B, HW, C), (B, C) f32 scale and bias -> (B, HW, C) in x's dtype.
    CPU: the plain version; CUDA: the kernel."""
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
    width = 16 // x.element_size()
    vec = c % width == 0 and x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0
    cb, rl, splits, groups = _geometry(c, hw, width if vec else 1)
    if b > _MAX_GRID_YZ or groups > _MAX_GRID_YZ:
        raise ValueError(f"{name}: B={b} or C={c} exceeds the kernel's grid")
    ws = torch.empty((b, splits, c, 2), device=x.device, dtype=torch.float32)
    coef = torch.empty((b, c, 4), device=x.device, dtype=torch.float32)
    err = LIBRARY.load().hst_instance_norm_fwd(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(), ws.data_ptr(),
        coef.data_ptr(), b, hw, c, cb, rl, splits, groups, float(eps), int(relu), int(vec),
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream,
    )
    check(name, err)
    LAUNCHES[name] += 1
    return y
