"""Request-body decoding of the HTTP front ends (``tasks/serving_http.py:
25-38`` of the JAX package); the classification server is not ported yet."""
from __future__ import annotations

from typing import Optional

import numpy as np


def _decode_image(body: bytes, raw_shape: Optional[str], staging: int) -> np.ndarray:
    """A raw uint8 H×W×3 body (``X-Raw-Shape: H,W,3``) as it is, or an
    encoded image (anything Pillow decodes, imported only then) staged to
    (staging, staging, 3)."""
    if raw_shape:
        h, w, c = (int(x) for x in raw_shape.split(","))
        if c != 3 or h <= 0 or w <= 0:
            raise ValueError(f"X-Raw-Shape must be H,W,3 with H,W > 0, got {raw_shape}")
        arr = np.frombuffer(body, dtype=np.uint8)
        if arr.size != h * w * c:
            raise ValueError("X-Raw-Shape does not match body size")
        return arr.reshape(h, w, c)
    from ..data.loader import decode_image_staged_bytes

    return decode_image_staged_bytes(body, staging)
