"""Feed-forward style network (``nn/transformer_net.py`` of the JAX
package): the Johnson et al. residual net with affine instance norm, which
stylises an image in one forward pass.

The module tree mirrors the JAX parameter tree, so the weight bridge
(``checkpoint/convert.py``) is a renaming: ``res.2.conv_a.weight`` is
``params["res"][2]["conv_a"]["kernel"]``, ``in1.weight`` is
``params["in1"]["scale"]``. Activations are NHWC tensors stored
``channels_last``; each of the 15 instance norms hands its (B, HW, C) view
to ``InstanceNormFunction`` (``ops/kernels/instance_norm.py``): on the card
``instance_norm_fwd`` forward and, where a gradient flows (training),
``instance_norm_bwd`` backward; on the CPU their plain versions. There is
no backend switch.

``compute_dtype=torch.bfloat16`` runs the conv stack in bf16; the
statistics, the [0, 1] boundary affines and the sigmoid stay f32.
A conditional net (``n_styles=S``) holds every instance-norm affine as an
(S, C) table; a per-image ``style_weights`` row (B, S) selects or blends
the affines as ``w @ table``.
"""
from __future__ import annotations

import copy
import functools
from typing import Optional

import torch
from torch import nn

from ..core.device import resolve_device
from ..ops.conv import conv2d
from ..ops.kernels.instance_norm import InstanceNormFunction
from ..ops.resize import IMAGENET_MEAN, IMAGENET_STD

EPS = 1e-5


class Conv2d(nn.Module):
    """Conv with bias, OIHW weight kept channels_last; ``conv2d_init``'s
    distribution (torch's nn.Conv2d default: weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in))) from an explicit generator."""

    def __init__(self, cin: int, cout: int, k: int, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        bound = 1.0 / (cin * k * k) ** 0.5

        def uniform(shape):
            return (torch.rand(shape, generator=generator, dtype=dtype) * 2 - 1) * bound

        self.weight = nn.Parameter(
            uniform((cout, cin, k, k)).to(device).contiguous(memory_format=torch.channels_last)
        )
        self.bias = nn.Parameter(uniform((cout,)).to(device))


class InstanceNorm(nn.Module):
    """Affine instance norm: a (C,) scale and bias, or (S, C) tables for a
    conditional net. ``is_affine_norm`` tells the weight bridge that a 2-D
    ``weight`` here is a table, not a linear kernel."""

    is_affine_norm = True

    def __init__(self, c: int, n_styles: Optional[int] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        shape = (c,) if n_styles is None else (int(n_styles), c)
        self.weight = nn.Parameter(torch.ones(shape, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(shape, device=device, dtype=dtype))


class ResBlock(nn.Module):
    def __init__(self, c: int, n_styles, generator, device, dtype):
        super().__init__()
        self.conv_a = Conv2d(c, c, 3, generator, device, dtype)
        self.in_a = InstanceNorm(c, n_styles, device, dtype)
        self.conv_b = Conv2d(c, c, 3, generator, device, dtype)
        self.in_b = InstanceNorm(c, n_styles, device, dtype)


class TransformerNet(nn.Module):
    def __init__(self, width: int = 32, n_res: int = 5, n_styles: Optional[int] = None,
                 generator: Optional[torch.Generator] = None, device=None,
                 dtype=torch.float32):
        super().__init__()
        w = int(width)
        g, d, t = generator, device, dtype
        self.conv1 = Conv2d(3, w, 9, g, d, t)
        self.in1 = InstanceNorm(w, n_styles, d, t)
        self.conv2 = Conv2d(w, 2 * w, 3, g, d, t)
        self.in2 = InstanceNorm(2 * w, n_styles, d, t)
        self.conv3 = Conv2d(2 * w, 4 * w, 3, g, d, t)
        self.in3 = InstanceNorm(4 * w, n_styles, d, t)
        self.res = nn.ModuleList(ResBlock(4 * w, n_styles, g, d, t) for _ in range(n_res))
        self.up1 = Conv2d(4 * w, 2 * w, 3, g, d, t)
        self.in_up1 = InstanceNorm(2 * w, n_styles, d, t)
        self.up2 = Conv2d(2 * w, w, 3, g, d, t)
        self.in_up2 = InstanceNorm(w, n_styles, d, t)
        self.out = Conv2d(w, 3, 9, g, d, t)


def transformer_net_init(
    generator: Optional[torch.Generator],
    width: int = 32,
    n_res: int = 5,
    n_styles: Optional[int] = None,
    device="cuda",
) -> TransformerNet:
    """The net in eval mode on ``device`` (``cuda`` unless the caller asks
    for ``cpu``), its random weights drawn from ``generator`` (a CPU
    ``torch.Generator``; None = the global one). width=32, n_res=5 is the
    classic configuration (about 1.68 M parameters)."""
    return TransformerNet(width, n_res, n_styles, generator, resolve_device(device)).eval()


def net_n_styles(net: TransformerNet) -> Optional[int]:
    """S for a conditional net, None for a single-style one."""
    scale = net.in1.weight
    return int(scale.shape[0]) if scale.dim() == 2 else None


def select_style(net: TransformerNet, index: int) -> TransformerNet:
    """Style ``index`` of a conditional net as a single-style net (every
    (S, C) affine sliced to (C,)) — exact, since a one-hot row is this
    slice."""
    out = copy.deepcopy(net)
    with torch.no_grad():
        for m in out.modules():
            if isinstance(m, InstanceNorm) and m.weight.dim() == 2:
                m.weight = nn.Parameter(m.weight[int(index)].clone())
                m.bias = nn.Parameter(m.bias[int(index)].clone())
    return out


def count_params(net: TransformerNet) -> int:
    return sum(p.numel() for p in net.parameters())


def _in_apply(m: InstanceNorm, x: torch.Tensor, style_w: Optional[torch.Tensor],
              relu: bool = False) -> torch.Tensor:
    """Affine instance norm of NHWC ``x`` with f32 statistics; a (S, C)
    table takes the per-image affine ``style_w @ table`` (B, C), a (C,)
    affine is repeated to (B, C) for the kernel. Gradients reach the
    affines through the product or the repeat."""
    b, h, w, c = x.shape
    scale, bias = m.weight.float(), m.bias.float()
    if scale.dim() == 2:
        if style_w is None:
            raise ValueError("conditional net: pass style_weights (B, S) to select/blend "
                             "per-style instance-norm affines")
        scale = style_w.float() @ scale
        bias = style_w.float() @ bias
    else:
        scale = scale.expand(b, c)
        bias = bias.expand(b, c)
    if x.device.type == "cuda" and not x.is_contiguous():
        raise ValueError(f"instance norm input {tuple(x.shape)} is not contiguous "
                         f"(strides {x.stride()}); keep activations in channels_last")
    y = InstanceNormFunction.apply(x.reshape(b, h * w, c), scale.contiguous(),
                                   bias.contiguous(), EPS, relu)
    return y.reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def _reflect_index(n: int, pad: int, device: torch.device) -> torch.Tensor:
    """Source index of each of n + 2*pad positions under reflect padding
    (no edge repeat, ``jnp.pad(mode="reflect")``). Never an inference
    tensor: one made first under ``inference_mode`` (serving) would be
    refused later where the gather saves it for a backward (training)."""
    if pad >= n:
        raise ValueError(f"reflect padding {pad} needs a side longer than {pad}, got {n}")
    with torch.inference_mode(False):
        i = torch.arange(-pad, n + pad).abs()
        return ((n - 1) - ((n - 1) - i).abs()).to(device)


def _reflect_conv(m: Conv2d, x: torch.Tensor, pad: int, stride: int = 1) -> torch.Tensor:
    """Reflect-pad H and W of NHWC ``x`` by one gather (the result is a
    contiguous NHWC tensor, so the conv stays channels_last), then conv."""
    if pad:
        _, h, w, _ = x.shape
        ih = _reflect_index(h, pad, x.device)
        iw = _reflect_index(w, pad, x.device)
        x = x[:, ih[:, None], iw[None, :], :].contiguous()
    return conv2d(x, m.weight, stride, 0, m.bias)


def _upsample2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 repeat of H and W, one copy into a contiguous NHWC
    tensor."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(b, 2 * h, 2 * w, c)


def transformer_net_apply(
    net: TransformerNet,
    images: torch.Tensor,
    compute_dtype: Optional[torch.dtype] = None,
    style_weights=None,
) -> torch.Tensor:
    """``images`` (B, H, W, 3) ImageNet-normalised -> stylised, same space.

    H and W must be multiples of 4. For a conditional net ``style_weights``
    is the per-image (B, S) mix row — required there, rejected on a
    single-style net; an (S,) row broadcasts over the batch."""
    cond = net_n_styles(net)
    if cond is None:
        if style_weights is not None:
            raise ValueError("style_weights given but the net is single-style")
        sw = None
    else:
        if style_weights is None:
            raise ValueError(f"conditional net ({cond} styles): style_weights is required")
        sw = torch.as_tensor(style_weights, dtype=torch.float32, device=images.device)
        if sw.dim() == 1:
            sw = sw[None]
        if sw.shape[-1] != cond:
            raise ValueError(f"style_weights last dim {sw.shape[-1]} != n_styles {cond}")
        sw = sw.expand(images.shape[0], cond)

    mean = torch.as_tensor(IMAGENET_MEAN, device=images.device)
    std = torch.as_tensor(IMAGENET_STD, device=images.device)
    x = images.float() * std + mean  # [0, 1] content
    if compute_dtype is not None:
        x = x.to(compute_dtype)

    def in_relu(m, v):
        return _in_apply(m, v, sw, relu=True)

    x = in_relu(net.in1, _reflect_conv(net.conv1, x, 4))
    x = in_relu(net.in2, _reflect_conv(net.conv2, x, 1, 2))
    x = in_relu(net.in3, _reflect_conv(net.conv3, x, 1, 2))
    for blk in net.res:
        y = in_relu(blk.in_a, _reflect_conv(blk.conv_a, x, 1))
        y = _in_apply(blk.in_b, _reflect_conv(blk.conv_b, y, 1), sw)
        x = x + y
    x = _upsample2(x)
    x = in_relu(net.in_up1, _reflect_conv(net.up1, x, 1))
    x = _upsample2(x)
    x = in_relu(net.in_up2, _reflect_conv(net.up2, x, 1))
    x = _reflect_conv(net.out, x, 4)

    y01 = torch.sigmoid(x.float())  # [0, 1] stylised
    return (y01 - mean) / std  # back to the normalised space
