"""Host-side image loading, staged for on-device preprocessing
(``data/loader.py`` of the JAX package, single host).

The host decodes each image and resizes it to a fixed ``STAGING_SIZE``
uint8 canvas (PIL bilinear shorter-side resize + center crop); the final
crop and normalisation run on the device (``data/augment.py``). Decoding
takes the PIL path only: the JAX package's native JPEG decoder gives
bit-identical pixels, so the same pixels come out. Pillow is imported when
a file is decoded, never at import.
"""
from __future__ import annotations

import concurrent.futures as cf
import io
from typing import Iterator, List, Sequence, Tuple

import numpy as np

from ..core.geometry import staging_geometry

STAGING_SIZE = 256
DECODE_WORKERS = 8
PREFETCH_BATCHES = 2


def decode_image_staged_bytes(data: bytes, staging: int = STAGING_SIZE) -> np.ndarray:
    """Encoded image bytes -> staged uint8 (staging, staging, 3): shorter
    side resized to ``staging`` (bilinear), center crop."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as im:
        im = im.convert("RGB")
        w, h = im.size
        tw, th, left, top = staging_geometry(w, h, staging)
        im = im.resize((tw, th), Image.BILINEAR)
        arr = np.asarray(im, dtype=np.uint8)
    return arr[top : top + staging, left : left + staging]


def load_image_staged(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_image_staged_bytes(f.read())


class HostLoader:
    """Threaded prefetching batch loader over (path, label) pairs, in
    order (evaluation; the shuffled training order comes with training).

    Yields dicts ``{"image": uint8 (B, S, S, 3), "label": int32 (B,),
    "indices": (B,), "n_valid": int}``. The last short batch is padded to
    ``batch_size`` by cycling samples from the start of the epoch order;
    pad entries carry label -1 and are not counted in ``n_valid``.
    ``num_workers`` threads decode; ``shuffle`` must stay False."""

    def __init__(self, samples: Sequence[Tuple[str, int]], batch_size: int,
                 shuffle: bool = False, num_workers: int = DECODE_WORKERS):
        if shuffle:
            raise NotImplementedError("HostLoader(shuffle=True) is not ported yet")
        self.samples = list(samples)
        self.batch_size = batch_size
        self.num_workers = max(1, num_workers)

    def __len__(self):
        return (len(self.samples) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[dict]:
        order = np.arange(len(self.samples))
        bs = self.batch_size
        batches: List[np.ndarray] = [order[i : i + bs] for i in range(0, len(order), bs)]

        # separate pools, so an assembler waiting on decodes never starves them
        decode_pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        batch_pool = cf.ThreadPoolExecutor(max_workers=PREFETCH_BATCHES)

        def make_batch(idxs: np.ndarray) -> dict:
            n = len(idxs)
            if n < bs:
                idxs = np.concatenate([idxs, order[np.arange(bs - n) % len(order)]])
            imgs = np.empty((bs, STAGING_SIZE, STAGING_SIZE, 3), dtype=np.uint8)
            decoded = decode_pool.map(lambda i: load_image_staged(self.samples[i][0]), idxs)
            for j, arr in enumerate(decoded):
                imgs[j] = arr
            labels = np.full((bs,), -1, dtype=np.int32)
            labels[:n] = [self.samples[i][1] for i in idxs[:n]]
            return {"image": imgs, "label": labels, "indices": np.asarray(idxs), "n_valid": n}

        pending = []
        try:
            for idxs in batches:
                pending.append(batch_pool.submit(make_batch, idxs))
                if len(pending) >= PREFETCH_BATCHES:
                    yield pending.pop(0).result()
            while pending:
                yield pending.pop(0).result()
        finally:
            batch_pool.shutdown(wait=False, cancel_futures=True)
            decode_pool.shutdown(wait=False, cancel_futures=True)
