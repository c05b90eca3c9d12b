"""Post-training int8 inference of the truncated ResNet50 encoder
(``nn/resnet_int8.py`` of the JAX package).

The scheme is JAX's:

- each batch norm folded into the conv before it (exact algebra, the eval
  batch norm);
- weights symmetric per output channel (scale maxabs/127, round half to
  even), activations symmetric per tensor with scales calibrated on the
  f32 eval forward (maxabs at the stem's input, after the stem, and at
  each block's h1, h2 and output);
- every map between convs stored as int8; each conv is int8 x int8 with
  exact int32 sums, then JAX's epilogue in JAX's order: ``y * (sx * sw) +
  b`` in f32, the residual added in f32, ReLU, and the next requant
  ``clamp(round(y / s), -127, 127)``.

The quantised tree is the JAX package's (``"stem"``, ``"layer1"``..., each
conv ``{"w": int8 HWIO, "sw": (O,) f32, "b": (O,) f32}``, ``"s_*"``
floats, ``"truncate"``), with torch tensors as leaves; ``save_quantized``
and ``load_quantized`` write and read its flat-key npz, so either package
reads the other's file.

The int8 convolution: JAX runs it as an XLA convolution with int32
accumulation, outside any Pallas kernel, so a library integer GEMM serves
here. The int8 NHWC map's patches are gathered in (kh, kw, C) order
(im2col; a 1x1 stride-1 conv needs no copy), which makes the HWIO weight's
(kh·kw·C, O) view the other operand. On the card that is
``torch._int_mm`` (cuBLASLt's integer tensor-core GEMM; it needs more than
16 rows and K and N multiples of 8: the stem's K of 147 is zero-padded to
152, which is exact). It raises rather than dequantising to float. On the
CPU the same GEMM runs in float64, where every int8 product and every sum
of them is exact.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch
from torch.fx.experimental.symbolic_shapes import statically_known_true

from ..core.device import resolve_device
from ..ops.conv import max_pool2d
from ..ops.norm import EPS, batch_norm
from .resnet import _STAGES

# ---- BN folding -----------------------------------------------------------


def fold_conv_bn(conv: Dict, bn: Dict, eps: float = EPS) -> Tuple[np.ndarray, np.ndarray]:
    """(kernel HWIO, bias O) of the JAX-layout ``conv`` and ``bn`` such
    that conv_b(x) == bn(conv(x)) in eval mode (numpy, float32)."""
    k = np.asarray(conv["kernel"], np.float32)
    scale = np.asarray(bn["scale"], np.float32)
    bias = np.asarray(bn["bias"], np.float32)
    mean = np.asarray(bn["mean"], np.float32)
    var = np.asarray(bn["var"], np.float32)
    inv = scale / np.sqrt(var + eps)
    return k * inv[None, None, None, :], bias - mean * inv


def _quantize_kernel(k: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-channel int8: (int8 kernel, f32 scale (O,))."""
    maxabs = np.abs(k).reshape(-1, k.shape[-1]).max(axis=0)
    s = np.where(maxabs > 0, maxabs / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(k / s[None, None, None, :]), -127, 127).astype(np.int8)
    return q, s


# ---- calibration ----------------------------------------------------------


def _maxabs(t: torch.Tensor) -> torch.Tensor:
    return t.abs().amax()


def calibrate_activation_scales(encoder, batches: Iterable[torch.Tensor],
                                truncate: int) -> Dict[str, Any]:
    """The f32 eval forward of ``encoder`` (a ``ResNet50Encoder``) over
    ``batches`` (normalised NHWC f32 on its device, the tensors the model
    takes), recording the maxabs at each quant point; returns the scale
    tree (maxabs/127 as Python floats), the quant points of the int8
    forward's dataflow (JAX ``:69-150``). One host read a batch."""

    def bn_eval(bn, x):
        return batch_norm(x, bn.weight, bn.bias, bn.running_mean, bn.running_var)

    agg: Dict[str, Any] = {}
    with torch.no_grad():
        for x in batches:
            x = x.float().contiguous()
            points = [_maxabs(x)]
            h = torch.relu(bn_eval(encoder.bn1, encoder.conv1(x)))
            points.append(_maxabs(h))
            h = max_pool2d(h, 3, 2, 1)
            names = []
            for si, (name, _, _, _) in enumerate(_STAGES):
                if truncate <= 4 + si:
                    break
                for block in getattr(encoder, name):
                    a = torch.relu(bn_eval(block.bn1, block.conv1(h)))
                    bq = torch.relu(bn_eval(block.bn2, block.conv2(a)))
                    cc = bn_eval(block.bn3, block.conv3(bq))
                    ds = block.downsample
                    identity = bn_eval(ds.bn, ds.conv(h)) if ds is not None else h
                    h = torch.relu(cc + identity)
                    points += [_maxabs(a), _maxabs(bq), _maxabs(h)]
                names.append(name)
            vals = torch.stack(points).cpu().tolist()
            for key, v in zip(("input", "stem"), vals[:2]):
                agg[key] = max(agg.get(key, 0.0), v)
            vals = vals[2:]
            for name in names:
                blocks = agg.setdefault(name, [dict() for _ in getattr(encoder, name)])
                for blk in blocks:
                    for key in ("h1", "h2", "out"):
                        blk[key] = max(blk.get(key, 0.0), vals.pop(0))

    def to_scale(v):
        return max(float(v), 1e-8) / 127.0

    scales: Dict[str, Any] = {"input": to_scale(agg["input"]), "stem": to_scale(agg["stem"])}
    for name, blocks in agg.items():
        if name not in ("input", "stem"):
            scales[name] = [{k: to_scale(v) for k, v in blk.items()} for blk in blocks]
    return scales


# ---- quantisation ---------------------------------------------------------


def _encoder_tree(encoder) -> Dict[str, Any]:
    if isinstance(encoder, dict):
        return encoder
    from ..checkpoint.convert import to_jax_tree

    return to_jax_tree(encoder)


def quantize_resnet50(encoder, act_scales: Dict[str, Any], truncate: int,
                      device="cuda") -> Dict[str, Any]:
    """BN folded, weights quantised, activation scales attached: the JAX
    quantised tree, its arrays as tensors on ``device``. ``encoder`` is a
    ``ResNet50Encoder`` or its JAX-layout tree; truncate in [4, 8] (the
    camera and evaluation feature range)."""
    if not 4 <= truncate <= 8:
        raise ValueError("int8 path supports truncate in [4, 8]")
    params = _encoder_tree(encoder)
    device = resolve_device(device)

    def qconv(conv, bn):
        k, b = fold_conv_bn(conv, bn)
        qk, sw = _quantize_kernel(k)
        return {"w": torch.from_numpy(qk).to(device), "sw": torch.from_numpy(sw).to(device),
                "b": torch.from_numpy(np.ascontiguousarray(b)).to(device)}

    q: Dict[str, Any] = {
        "s_input": float(act_scales["input"]),
        "stem": qconv(params["conv1"], params["bn1"]),
        "s_stem": float(act_scales["stem"]),
        "truncate": truncate,
    }
    for si, (name, _, _, _) in enumerate(_STAGES):
        if truncate <= 4 + si:
            break
        qstage = []
        for block, ascale in zip(params[name], act_scales[name]):
            qb = {
                "conv1": qconv(block["conv1"], block["bn1"]),
                "conv2": qconv(block["conv2"], block["bn2"]),
                "conv3": qconv(block["conv3"], block["bn3"]),
                "s_h1": float(ascale["h1"]),
                "s_h2": float(ascale["h2"]),
                "s_out": float(ascale["out"]),
            }
            if "downsample" in block:
                qb["downsample"] = qconv(block["downsample"]["conv"], block["downsample"]["bn"])
            qstage.append(qb)
        q[name] = qstage
    return q


def prepare_int8_resnet(encoder, calibration_batches: Iterable[torch.Tensor],
                        truncate: int = 8) -> Dict[str, Any]:
    """One-call PTQ of a ``ResNet50Encoder``: calibrate on normalised f32
    batches, then quantise onto the encoder's device."""
    scales = calibrate_activation_scales(encoder, calibration_batches, truncate)
    return quantize_resnet50(encoder, scales, truncate,
                             device=next(encoder.parameters()).device)


# ---- persistence ----------------------------------------------------------


def _to_numpy(node):
    if isinstance(node, dict):
        return {k: _to_numpy(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_to_numpy(v) for v in node]
    if torch.is_tensor(node):
        return node.detach().cpu().numpy()
    return node


def save_quantized(q: Dict[str, Any], path: str) -> None:
    """The quantised tree as the JAX package's atomic flat-key npz."""
    from ..checkpoint.io import save_pytree_npz

    save_pytree_npz(_to_numpy(q), path)


def load_quantized(path: str, device="cuda") -> Dict[str, Any]:
    """A ``save_quantized`` file of either package: int8 and f32 leaves as
    tensors on ``device``, the activation scales and the truncate index as
    Python numbers."""
    from ..checkpoint.io import load_pytree_npz

    device = resolve_device(device)

    def restore(node):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if k.startswith("s_"):
                    out[k] = float(np.asarray(v))
                elif k == "truncate":
                    out[k] = int(np.asarray(v))
                else:
                    out[k] = restore(v)
            return out
        if isinstance(node, list):
            return [restore(v) for v in node]
        return torch.from_numpy(np.ascontiguousarray(node)).to(device)

    return restore(load_pytree_npz(path))


# ---- int8 forward ---------------------------------------------------------


def _im2col(x: torch.Tensor, kh: int, kw: int, stride: int, padding: int) -> torch.Tensor:
    """(N, H, W, C) int8 -> (N·Ho·Wo, kh·kw·C) patches in (kh, kw, C)
    order, the rows of the HWIO weight's (kh·kw·C, O) view."""
    n, _, _, c = x.shape
    if kh == kw == 1 and padding == 0:
        if stride != 1:
            x = x[:, ::stride, ::stride, :]
        return x.reshape(-1, c)
    if padding:
        x = torch.nn.functional.pad(x, (0, 0, padding, padding, padding, padding))
    p = x.unfold(1, kh, stride).unfold(2, kw, stride)  # (N, Ho, Wo, C, kh, kw)
    return p.permute(0, 1, 2, 4, 5, 3).reshape(-1, kh * kw * c)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 x (K, N) int8 -> (M, N) int32, exact. On the card
    ``torch._int_mm`` (K zero-padded to a multiple of 8, M to more than
    16 rows); on the CPU a float64 GEMM, exact for these sizes. A failure
    on the card raises. Under ``torch.export`` M may be symbolic (B Ho Wo
    of a symbolic batch): a served conv's M is at least 49, so where M >=
    17 is known from its range no pad, and no guard, is traced."""
    m, k = a.shape
    if a.device.type == "cuda":
        pad_k = (-k) % 8
        pad_m = 0 if statically_known_true(m >= 17) else max(0, 17 - m)
        if pad_k or pad_m:
            a = torch.nn.functional.pad(a, (0, pad_k, 0, pad_m))
            b = torch.nn.functional.pad(b, (0, 0, 0, pad_k))
        return torch._int_mm(a.contiguous(), b.contiguous())[:m]
    return (a.double() @ b.double()).to(torch.int32)


def _conv_i8(x_i8: torch.Tensor, qc: Dict, sx: float, stride: int = 1,
             padding: int = 0) -> torch.Tensor:
    """int8 conv -> the f32 dequantised, bias-added output (NHWC)."""
    kh, kw, cin, cout = qc["w"].shape
    n, h, w, _ = x_i8.shape
    ho = (h + 2 * padding - kh) // stride + 1
    wo = (w + 2 * padding - kw) // stride + 1
    y = int8_matmul(_im2col(x_i8, kh, kw, stride, padding), qc["w"].reshape(-1, cout))
    return (y.float() * (qc["sw"] * sx) + qc["b"]).reshape(n, ho, wo, cout)


def _requant(y: torch.Tensor, s: float) -> torch.Tensor:
    """clamp(round(y / s), -127, 127) as int8; the divisor is a tensor on
    y's device, so the card divides as the CPU does (a Python scalar
    would become a multiply by its reciprocal there)."""
    s_t = torch.full((), s, dtype=torch.float32, device=y.device)
    return torch.round(y / s_t).clamp_(-127, 127).to(torch.int8)


def _max_pool_i8(h: torch.Tensor) -> torch.Tensor:
    """The stem's 3x3/2 max-pool of an int8 map, taken on the map widened
    to float32 (every int8 value exact there, so bit-equal to pooling the
    integers) and cast back."""
    return max_pool2d(h.float(), 3, 2, 1).to(torch.int8)


def resnet50_apply_int8(q: Dict[str, Any], x: torch.Tensor, collect_grams: bool = False,
                        gram_pool_size: Optional[int] = None) -> Any:
    """x: normalised f32 NHWC on the tree's device -> f32 features after
    child ``q["truncate"]``, every map between convs stored as int8 (JAX
    ``:226-308``). ``collect_grams``: also one Gram a stage of the
    dequantised stage output, (S, S) pooled with ``gram_pool_size``
    (``pooled_gram_fwd`` on the card); returns (features, grams) then."""
    from ..ops.gram import gram_matrix_nhwc, pooled_gram_nhwc

    truncate = q["truncate"]
    grams: List[torch.Tensor] = []
    with torch.no_grad():
        xq = _requant(x.float(), q["s_input"])
        h = _requant(torch.relu(_conv_i8(xq, q["stem"], q["s_input"], 2, 3)), q["s_stem"])
        s = q["s_stem"]
        h = _max_pool_i8(h)
        for si, (name, _, _, stride) in enumerate(_STAGES):
            if truncate <= 4 + si:
                break
            for b, qb in enumerate(q[name]):
                st = stride if b == 0 else 1
                a = _requant(torch.relu(_conv_i8(h, qb["conv1"], s)), qb["s_h1"])
                bq = _requant(torch.relu(_conv_i8(a, qb["conv2"], qb["s_h1"], st, 1)),
                              qb["s_h2"])
                y = _conv_i8(bq, qb["conv3"], qb["s_h2"])
                if "downsample" in qb:
                    identity = _conv_i8(h, qb["downsample"], s, st)
                else:
                    identity = h.float() * s
                h = _requant(torch.relu(y + identity), qb["s_out"])
                s = qb["s_out"]
            if collect_grams:
                hf = h.float() * s
                grams.append(pooled_gram_nhwc(hf, gram_pool_size) if gram_pool_size is not None
                             else gram_matrix_nhwc(hf))
        feats = h.float() * s
    if collect_grams:
        return feats, grams
    return feats
