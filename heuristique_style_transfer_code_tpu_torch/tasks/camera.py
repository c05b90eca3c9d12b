"""Host-side frame downscale (``tasks/camera.py:198-210`` of the JAX
package); the camera loop itself is not ported yet. OpenCV is imported only
when a frame needs resizing."""
from __future__ import annotations

import numpy as np

from ..core.geometry import center_crop_offsets, resize_target


def downscale_frame(rgb: np.ndarray, crop: int = 224, shorter: int = 256) -> np.ndarray:
    """Shorter side -> ``shorter`` (cv2 INTER_AREA), center crop ``crop``.
    A frame already at the target size is only cropped: cv2 returns it
    unchanged there, so the path needs no OpenCV."""
    h, w = rgb.shape[:2]
    th, tw = resize_target(h, w, shorter)
    if (th, tw) == (h, w):
        resized = rgb
    else:
        import cv2

        resized = cv2.resize(rgb, (tw, th), interpolation=cv2.INTER_AREA)
    top, left = center_crop_offsets(th, tw, crop)
    return resized[top : top + crop, left : left + crop]
