"""Device-side preprocessing (``data/augment.py`` of the JAX package): the
eval path (``:323-327``) and the train step's augmentation function
(``make_augment_fn``, ``:285-320``) over the reference's transform
combinations, each a (geometric, colour) pair of which either may be the
identity.

The ten transforms, each in a deterministic form (``:56-225``) and a random
one with the JAX ranges (``:121-258``):

    colour     brightness, contrast, saturation (factor 0.5-1.5), hue
               (shift +-0.1 turn, the float HSV round trip), grayscale
    geometric  horizontal and vertical flip, rotation (+-15 degrees),
               affine (+-15 degrees, scale 0.9-1.1, translation +-0.1 of
               the size, continuous), resized crop (area 0.8-1 of the
               canvas, log aspect ratio in [ln 3/4, ln 4/3], sides clipped
               to [8, size]) back onto the canvas

Every geometric transform is an inverse map ``src = M (dst + p) + o``,
clamped to a box for the resized crop, sampled bilinearly with each corner
outside the canvas counting 0: ``map_coordinates(order=1,
mode="constant")`` in JAX, the same arithmetic here. Every colour
transform but hue is a blend ``clip(img * f + t * (1 - f))`` towards 0
(brightness), the mean luma (contrast) or the luma map (saturation; and
grayscale, f = 0).

Where the JAX package draws each image's parameters on the device from a
``jax.random`` key, the port draws ``N_DRAWS`` uniforms per image on the
host from a CPU ``torch.Generator`` (``batch_draws``: one generator per
batch, seeded from the run's seed, the fold, the epoch and the batch's
index, so a resumed run draws the same numbers). ``augment_params`` maps
them, with each image's combination, to ``N_PARAMS`` coefficients in
float32 on the host; the batch's (B, N_PARAMS) table goes to the device
with the images, and the card and the CPU transform with the same numbers.
A batch takes the same launches whatever combinations it holds: one warp
over per-image coordinates, one blend with per-image factors, and the hue
round trip masked per image, each run where some combination of the run
needs it.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.resize import center_crop, normalize_imagenet

AVAILABLE_COLOR_TRANSFORMS = ("brightness", "contrast", "saturation", "hue", "grayscale")
AVAILABLE_GEOM_TRANSFORMS = (
    "horizontal_flip",
    "vertical_flip",
    "rotation",
    "affine",
    "resized_crop",
)

# ITU-R 601-2 luma, PIL convert("L")
_LUMA = (0.299, 0.587, 0.114)

# uniforms drawn per image: four for the geometric transform, one for the colour one
N_DRAWS = 5
# a geometric row: m00 m01 m10 m11, the half-pixel p, the y offsets (two,
# added in turn), the x offsets, the clamp box (y low, y high, x low, x high);
# then the colour kind and its factor
_GEOM = 13
N_PARAMS = _GEOM + 2
_NONE, _BRIGHTNESS, _CONTRAST, _SATURATION, _HUE, _GRAYSCALE = range(6)
_COLOR_KIND = {None: _NONE, "brightness": _BRIGHTNESS, "contrast": _CONTRAST,
               "saturation": _SATURATION, "hue": _HUE, "grayscale": _GRAYSCALE}


def eval_preprocess(images_u8: torch.Tensor, crop: int = 224) -> torch.Tensor:
    """Staged uint8 (N, H, W, 3) -> /255 -> center crop -> ImageNet
    normalisation, float32 NHWC, contiguous."""
    img = images_u8.to(torch.float32) / 255.0
    return normalize_imagenet(center_crop(img, crop)).contiguous()


# ------------------------------------------------------ host-side parameters


def _per_image(value, b: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(value, np.float32), (b,)).astype(np.float32)


def _identity_rows(b: int) -> np.ndarray:
    rows = np.zeros((b, _GEOM), np.float32)
    rows[:, 0] = rows[:, 3] = 1.0
    rows[:, 9] = rows[:, 11] = -np.inf
    rows[:, 10] = rows[:, 12] = np.inf
    return rows


def _flip_rows(b: int, h: int, w: int, axis: int) -> np.ndarray:
    """src = (size - 1) - dst along ``axis`` (0: rows, 1: columns)."""
    rows = _identity_rows(b)
    if axis == 0:
        rows[:, 0], rows[:, 5] = -1.0, h - 1
    else:
        rows[:, 3], rows[:, 7] = -1.0, w - 1
    return rows


def _rotation_rows(angle_rad, h: int, w: int, scale=1.0, ty=0.0, tx=0.0) -> np.ndarray:
    """JAX ``_rotation_matrix`` (``:174-186``) per image, in float32: the
    inverse affine about the centre ((h-1)/2, (w-1)/2), M = R(theta) / s,
    offset = c - M (c + t)."""
    angle = np.asarray(angle_rad, np.float32).reshape(-1)
    b = angle.shape[0]
    scale, ty, tx = _per_image(scale, b), _per_image(ty, b), _per_image(tx, b)
    cy, cx = np.float32((h - 1) / 2.0), np.float32((w - 1) / 2.0)
    cos, sin = np.cos(angle) / scale, np.sin(angle) / scale
    vy, vx = cy + ty, cx + tx
    rows = _identity_rows(b)
    rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3] = cos, -sin, sin, cos
    rows[:, 5] = cy - (cos * vy + -sin * vx)
    rows[:, 7] = cx - (sin * vy + cos * vx)
    return rows


def _crop_rows(top, left, ch, cw, h: int, w: int) -> np.ndarray:
    """JAX ``resized_crop_box`` (``:210-225``): src = (dst + 0.5) * (c / size)
    - 0.5 + offset, clamped to [offset, offset + c - 1]."""
    top = np.asarray(top, np.float32).reshape(-1)
    b = top.shape[0]
    left, ch, cw = _per_image(left, b), _per_image(ch, b), _per_image(cw, b)
    rows = _identity_rows(b)
    rows[:, 0], rows[:, 3] = ch / np.float32(h), cw / np.float32(w)
    rows[:, 4] = 0.5
    rows[:, 5], rows[:, 6], rows[:, 7], rows[:, 8] = -0.5, top, -0.5, left
    rows[:, 9], rows[:, 10] = top, top + ch - np.float32(1.0)
    rows[:, 11], rows[:, 12] = left, left + cw - np.float32(1.0)
    return rows


def rotation_draw(u0):
    """Degrees, uniform in [-15, 15)."""
    return np.float32(-15.0) + np.float32(30.0) * np.asarray(u0, np.float32)


def affine_draw(u, h: int, w: int):
    """(degrees, scale, ty, tx) from four uniforms: +-15 degrees, scale
    0.9-1.1, translation +-0.1 of the size in pixels (continuous)."""
    u = np.asarray(u, np.float32)
    deg = np.float32(-15.0) + np.float32(30.0) * u[..., 0]
    scale = np.float32(0.9) + np.float32(0.2) * u[..., 1]
    ty = (np.float32(-0.1) + np.float32(0.2) * u[..., 2]) * np.float32(h)
    tx = (np.float32(-0.1) + np.float32(0.2) * u[..., 3]) * np.float32(w)
    return deg, scale, ty, tx


def resized_crop_draw(u, h: int, w: int):
    """(top, left, ch, cw) from four uniforms: area 0.8-1 of the canvas, log
    aspect ratio in [ln 3/4, ln 4/3], sides clipped to [8, size]."""
    u = np.asarray(u, np.float32)
    area = (np.float32(0.8) + np.float32(0.2) * u[..., 0]) * np.float32(h) * np.float32(w)
    lo, hi = np.float32(math.log(3.0 / 4.0)), np.float32(math.log(4.0 / 3.0))
    ratio = np.exp(lo + (hi - lo) * u[..., 1])
    ch = np.clip(np.sqrt(area / ratio), 8.0, h).astype(np.float32)
    cw = np.clip(np.sqrt(area * ratio), 8.0, w).astype(np.float32)
    top = u[..., 2] * (np.float32(h) - ch)
    left = u[..., 3] * (np.float32(w) - cw)
    return top, left, ch, cw


def color_draw(name: Optional[str], u4):
    """The colour transform's factor: 0.5-1.5 for brightness, contrast and
    saturation, the hue shift in [-0.1, 0.1), 0 for grayscale (its blend
    weight), 1 for none."""
    u4 = np.asarray(u4, np.float32)
    if name in ("brightness", "contrast", "saturation"):
        return np.float32(0.5) + u4
    if name == "hue":
        return np.float32(-0.1) + np.float32(0.2) * u4
    return np.full_like(u4, 0.0 if name == "grayscale" else 1.0)


def _geom_rows(name: Optional[str], u: np.ndarray, h: int, w: int) -> np.ndarray:
    b = u.shape[0]
    if name is None:
        return _identity_rows(b)
    if name == "horizontal_flip":
        return _flip_rows(b, h, w, 1)
    if name == "vertical_flip":
        return _flip_rows(b, h, w, 0)
    if name == "rotation":
        return _rotation_rows(-np.deg2rad(rotation_draw(u[:, 0])), h, w)
    if name == "affine":
        deg, scale, ty, tx = affine_draw(u, h, w)
        return _rotation_rows(np.deg2rad(deg), h, w, scale, ty, tx)
    if name == "resized_crop":
        return _crop_rows(*resized_crop_draw(u, h, w), h, w)
    raise ValueError(f"unknown geometric transform {name!r}")


def augment_params(combos: Sequence[Tuple[Optional[str], Optional[str]]], combo_ids,
                   draws, h: int, w: int) -> np.ndarray:
    """Each image's combination and ``N_DRAWS`` uniforms -> its (N_PARAMS,)
    float32 coefficients on an h x w canvas."""
    ids = np.asarray(combo_ids, np.int64).reshape(-1)
    draws = np.asarray(draws, np.float32).reshape(len(ids), N_DRAWS)
    out = np.zeros((len(ids), N_PARAMS), np.float32)
    for cid in np.unique(ids):
        geom, color = combos[int(cid)]
        sel = ids == cid
        out[sel, :_GEOM] = _geom_rows(geom, draws[sel], h, w)
        out[sel, _GEOM] = _COLOR_KIND[color]
        out[sel, _GEOM + 1] = color_draw(color, draws[sel, 4])
    return out


def batch_draws(key: Sequence[int], n: int) -> np.ndarray:
    """(n, N_DRAWS) float32 uniforms in [0, 1) from a CPU ``torch.Generator``
    seeded by ``key`` (non-negative ints: the run's seed, the fold, the
    epoch, the batch's index)."""
    hi, lo = np.random.SeedSequence([int(k) for k in key]).generate_state(2)
    gen = torch.Generator().manual_seed((int(hi) << 32) | int(lo))
    return torch.rand((n, N_DRAWS), generator=gen).numpy()


# ------------------------------------------------------- device-side transforms


def warp(img: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """img (B, H, W, 3) float, rows (B, 13) float32 geometric coefficients
    on img's device -> the bilinear inverse-mapped image, each corner
    outside the canvas counting 0 (JAX ``map_coordinates(order=1,
    mode="constant")``, its weights and sum order)."""
    b, h, w, c = img.shape
    r = rows.to(torch.float32)[:, :, None, None]
    yy = torch.arange(h, device=img.device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=img.device, dtype=torch.float32)[None, :]
    ys, xs = yy + r[:, 4], xx + r[:, 4]
    sy = (((r[:, 0] * ys + r[:, 1] * xs) + r[:, 5]) + r[:, 6]).clamp(r[:, 9], r[:, 10])
    sx = (((r[:, 2] * ys + r[:, 3] * xs) + r[:, 7]) + r[:, 8]).clamp(r[:, 11], r[:, 12])
    flat = img.reshape(b, h * w, c)
    corners = []
    for s in (sy, sx):
        low = torch.floor(s)
        upper_w = s - low
        index = low.to(torch.int64)
        corners.append(((index, 1 - upper_w), (index + 1, upper_w)))
    out = None
    for iy, wy in corners[0]:
        for ix, wx in corners[1]:
            valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
            idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(b, h * w, 1)
            v = torch.gather(flat, 1, idx.expand(b, h * w, c)).reshape(b, h, w, c)
            term = torch.where(valid[..., None], v, torch.zeros((), dtype=v.dtype,
                                                                 device=v.device))
            term = term * (wy * wx)[..., None]
            out = term if out is None else out + term
    return out


def _luma(img: torch.Tensor) -> torch.Tensor:
    return img[..., 0] * _LUMA[0] + img[..., 1] * _LUMA[1] + img[..., 2] * _LUMA[2]


def _blend(img: torch.Tensor, kind: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """clip(img * f + t * (1 - f)) per image: t = 0 (brightness), the mean
    luma (contrast) or the luma map (saturation, grayscale); f = 1 leaves
    the image (clipped to [0, 1])."""
    gray = _luma(img)
    k = kind[:, None, None]
    target = torch.where(k == _CONTRAST, gray.mean(dim=(1, 2))[:, None, None], gray)
    target = torch.where(k == _BRIGHTNESS, torch.zeros((), device=img.device), target)
    f = factor[:, None, None, None]
    return torch.clamp(img * f + target[..., None] * (1.0 - f), 0.0, 1.0)


def _hue(img: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """JAX ``adjust_hue`` (``:79-112``) with a per-image shift (B,): the
    float HSV round trip of torchvision's tensor path."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = img.amax(dim=-1)
    minc = img.amin(dim=-1)
    eqc = maxc == minc
    cr = maxc - minc
    ones = torch.ones_like(maxc)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    s = cr / torch.where(eqc, ones, maxc)
    cr_div = torch.where(eqc, ones, cr)
    rc, gc, bc = (maxc - r) / cr_div, (maxc - g) / cr_div, (maxc - b) / cr_div
    hr = torch.where(maxc == r, bc - gc, zero)
    hg = torch.where((maxc == g) & (maxc != r), 2.0 + rc - bc, zero)
    hb = torch.where((maxc != g) & (maxc != r), 4.0 + gc - rc, zero)
    h = torch.remainder((hr + hg + hb) / 6.0, 1.0)
    h = torch.remainder(h + shift.reshape(-1, *([1] * (h.dim() - 1))), 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    sextant = torch.remainder(i.to(torch.int64), 6)[..., None]
    v = maxc
    p = torch.clamp(v * (1.0 - s), 0.0, 1.0)
    q = torch.clamp(v * (1.0 - s * f), 0.0, 1.0)
    t = torch.clamp(v * (1.0 - s * (1.0 - f)), 0.0, 1.0)
    pick = [torch.stack(vals, dim=-1).gather(-1, sextant)[..., 0]
            for vals in ((v, q, p, p, t, v), (t, v, v, q, p, p), (p, p, t, v, v, q))]
    return torch.stack(pick, dim=-1)


# ------------------------------------------------------ deterministic forms
# (B, H, W, 3) float [0, 1] images; a parameter is a number or one per image


def _rows_on(rows: np.ndarray, img: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(rows).to(img.device)


def _color_on(img: torch.Tensor, kind: int, factor) -> Tuple[torch.Tensor, torch.Tensor]:
    b = img.shape[0]
    return (torch.full((b,), kind, dtype=torch.int64, device=img.device),
            torch.as_tensor(_per_image(factor, b)).to(img.device))


def adjust_brightness(img, factor):
    """PIL ImageEnhance.Brightness: clip(img * f)."""
    return _blend(img, *_color_on(img, _BRIGHTNESS, factor))


def adjust_contrast(img, factor):
    """PIL ImageEnhance.Contrast: blend towards the image's mean luma."""
    return _blend(img, *_color_on(img, _CONTRAST, factor))


def adjust_saturation(img, factor):
    """PIL ImageEnhance.Color: blend towards the luma map."""
    return _blend(img, *_color_on(img, _SATURATION, factor))


def adjust_hue(img, shift):
    return _hue(img, _color_on(img, _HUE, shift)[1])


def to_grayscale(img):
    """The luma map on three channels (a blend of weight 0 towards it)."""
    return _blend(img, *_color_on(img, _GRAYSCALE, 0.0))


def horizontal_flip(img):
    b, h, w, _ = img.shape
    return warp(img, _rows_on(_flip_rows(b, h, w, 1), img))


def vertical_flip(img):
    b, h, w, _ = img.shape
    return warp(img, _rows_on(_flip_rows(b, h, w, 0), img))


def rotate_by(img, deg):
    """F.rotate(deg): positive is counterclockwise, hence -deg into the
    shared matrix (JAX ``:189-197``); bilinear."""
    b, h, w, _ = img.shape
    angle = -np.deg2rad(_per_image(deg, b))
    return warp(img, _rows_on(_rotation_rows(angle, h, w), img))


def affine_by(img, deg, translate=(0.0, 0.0), scale=1.0):
    """F.affine(deg, translate=(tx, ty) pixels, scale), no shear, bilinear."""
    b, h, w, _ = img.shape
    tx, ty = translate
    rows = _rotation_rows(np.deg2rad(_per_image(deg, b)), h, w, scale, ty, tx)
    return warp(img, _rows_on(rows, img))


def resized_crop_box(img, top, left, ch, cw):
    """The box (top, left, ch, cw) upsampled onto the whole canvas,
    half-pixel centres, source coordinates clamped to the box."""
    b, h, w, _ = img.shape
    rows = _crop_rows(_per_image(top, b), left, ch, cw, h, w)
    return warp(img, _rows_on(rows, img))


# ----------------------------------------------------------- combinations


def generate_transform_combinations(
    geom_names: Sequence[Optional[str]], color_names: Sequence[Optional[str]]
) -> List[Tuple[Optional[str], Optional[str]]]:
    """Cartesian product (geom x color), None = identity (JAX ``:275-282``)."""
    geoms = list(geom_names) or [None]
    colors = list(color_names) or [None]
    return [(g, c) for g in geoms for c in colors]


def make_augment_fn(combos: Sequence[Tuple[Optional[str], Optional[str]]],
                    crop: int = 224) -> Callable:
    """``augment(images_u8, combo_ids=None, draws=None) -> float32 (B, crop,
    crop, 3)`` for the train step: /255, each image's combination (its
    geometric transform, then its colour one) with the parameters that
    ``augment_params`` derives from its draws, centre crop, ImageNet
    normalisation. ``images_u8`` is (B, S, S, 3) uint8 on the device;
    ``combo_ids`` (B,) indexes ``combos``; ``draws`` is (B, N_DRAWS) from
    ``batch_draws``. With the identity combination alone every image is
    ``eval_preprocess``'s, and neither is needed."""
    combos = list(combos)
    if not combos:
        raise ValueError("make_augment_fn needs at least one (geom, color) combination")
    for geom, color in combos:
        if geom is not None and geom not in AVAILABLE_GEOM_TRANSFORMS:
            raise ValueError(f"unknown geometric transform {geom!r}")
        if color is not None and color not in AVAILABLE_COLOR_TRANSFORMS:
            raise ValueError(f"unknown colour transform {color!r}")
    has_geom = any(g is not None for g, _ in combos)
    has_blend = any(c not in (None, "hue") for _, c in combos)
    has_hue = any(c == "hue" for _, c in combos)

    def augment(images_u8: torch.Tensor, combo_ids=None, draws=None) -> torch.Tensor:
        if not (has_geom or has_blend or has_hue):
            return eval_preprocess(images_u8, crop)
        b, h, w, _ = images_u8.shape
        if draws is None:
            raise ValueError("augmentation needs each image's draws (data.augment.batch_draws)")
        ids = np.zeros(b, np.int64) if combo_ids is None else np.asarray(
            combo_ids.cpu() if torch.is_tensor(combo_ids) else combo_ids)
        draws = draws.cpu() if torch.is_tensor(draws) else draws
        params = torch.as_tensor(augment_params(combos, ids, draws, h, w)).to(images_u8.device)
        img = images_u8.to(torch.float32) / 255.0
        if has_geom:
            img = warp(img, params[:, :_GEOM])
        kind = params[:, _GEOM].to(torch.int64)
        factor = params[:, _GEOM + 1]
        if has_blend:  # a hue image passes the blend unchanged (f = 1)
            img = _blend(img, kind, torch.where(kind == _HUE, 1.0, factor))
        if has_hue:
            img = torch.where((kind == _HUE)[:, None, None, None], _hue(img, factor), img)
        return normalize_imagenet(center_crop(img, crop)).contiguous()

    return augment
