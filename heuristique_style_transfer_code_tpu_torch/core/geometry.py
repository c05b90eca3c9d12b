"""Host-side resize/crop geometry (pure Python): the integer rules of the
reference transform, torchvision ``Resize(shorter)`` + ``center_crop``.

Own copy of ``heuristique_style_transfer_code_tpu/core/geometry.py`` (the
port imports nothing of the JAX package): ``resize_target`` TRUNCATES the
scaled long side, ``center_crop_offsets`` uses Python ``round`` on the
half-gap.
"""
from __future__ import annotations

from typing import Tuple


def resize_target(h: int, w: int, shorter: int) -> Tuple[int, int]:
    """Scale the shorter side to ``shorter`` keeping the aspect ratio;
    returns (target_h, target_w)."""
    if h <= w:
        return shorter, max(1, int(w * shorter / h))
    return max(1, int(h * shorter / w)), shorter


def center_crop_offsets(h: int, w: int, size: int) -> Tuple[int, int]:
    """round((in - out) / 2), clamped at 0; returns (top, left)."""
    top = int(round((h - size) / 2.0)) if h > size else 0
    left = int(round((w - size) / 2.0)) if w > size else 0
    return top, left


def staging_geometry(w: int, h: int, staging: int) -> Tuple[int, int, int, int]:
    """Staged-decode plan for a (w, h) source: resize so the shorter side is
    ``staging``, center-crop (staging, staging). Returns
    (target_w, target_h, left, top)."""
    th, tw = resize_target(h, w, staging)
    top, left = center_crop_offsets(th, tw, staging)
    return tw, th, left, top
