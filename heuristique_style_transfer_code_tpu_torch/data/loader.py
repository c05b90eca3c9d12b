"""Host-side image loading, staged for on-device preprocessing
(``data/loader.py`` of the JAX package).

The host decodes each image and resizes it to a fixed ``STAGING_SIZE``
uint8 canvas (PIL bilinear shorter-side resize + center crop); the final
crop and normalisation run on the device (``data/augment.py``). JPEG bytes
take the native decoder first (``native/``: libjpeg and Pillow's resample
in C++, bit-identical, without the GIL), other bytes and any native
failure PIL. Pillow is imported when a file is decoded, never at import.
"""
from __future__ import annotations

import concurrent.futures as cf
import io
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..core.geometry import staging_geometry
from ..native import get_decoder, is_jpeg

STAGING_SIZE = 256
DECODE_WORKERS = 8
PREFETCH_BATCHES = 2


def decode_image_staged_bytes(data: bytes, staging: int = STAGING_SIZE) -> np.ndarray:
    """Encoded image bytes -> staged uint8 (staging, staging, 3): shorter
    side resized to ``staging`` (bilinear), center crop (JAX
    ``data/loader.py:27-50``). JPEG bytes take the native decoder where it
    is on (``native.get_decoder``; ``HST_NATIVE_DECODE_FAST=1`` its fast,
    not bit-identical path), the rest PIL: the one implementation of the
    file loader and the classification server, so both feed the same
    pixels."""
    dec = get_decoder()
    if dec is not None and is_jpeg(data):
        fast = os.environ.get("HST_NATIVE_DECODE_FAST") == "1"
        arr = dec.decode_staged(data, staging, fast=fast)
        if arr is not None:
            return arr
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
    """Threaded prefetching batch loader over (path, label) pairs
    (``data/loader.py:60-217`` of the JAX package).

    Yields dicts ``{"image": uint8 (B, S, S, 3), "label": int32 (B,),
    "combo": int32 (B,), "indices": (B,), "n_valid": int}``. The last
    short batch is padded to ``batch_size`` by cycling samples from the
    start of the epoch order; pad entries carry label -1 and are not
    counted in ``n_valid``, and keep their sample's combination id
    (``combo_ids``, one per sample, 0 where not given), as the JAX
    loader's do. ``num_workers`` threads decode. With ``shuffle`` each
    epoch's order is ``np.random.RandomState(seed + epoch)``'s
    permutation, and each ``__iter__`` advances the epoch, so a fresh
    loader gives the JAX loader's orders. With ``draw_key`` (non-negative
    ints) each batch also carries ``"draws"``, the (B, N_DRAWS)
    augmentation uniforms of ``data.augment.batch_draws(draw_key + (epoch,
    batch index))``: the same numbers for a batch however the epoch was
    reached (``set_epoch``, ``set_position``), and ``"mix_key"``, that
    tuple itself, from which ``train/mixing.py`` draws the batch's mixing
    on a generator of its own.

    ``rows`` (a data-parallel rank's ``core.mesh.Mesh.rows(batch_size,
    n_accum)``) keeps this rank's rows of every global batch: only those
    are decoded, and "image", "label", "combo", "indices" and "draws" hold
    them (the draws being those rows of the global batch's draws), while
    "n_valid" stays the global batch's valid count.

    ``process_index``/``process_count`` (JAX's multi-host stride): every
    process draws a disjoint stride of the same epoch order (seeded by
    ``seed + epoch``, so the processes agree without communicating). The
    order is first padded, cycling from its start, to a multiple of
    ``process_count * batch_size``, so every process runs the same number
    of batches; a padded entry carries label -1 and is not counted in
    "n_valid", in a full batch as in the last. On a mesh the process is
    the rank's data index (``core.mesh.Mesh.data_index``) and the count
    the data axis's size: the ranks of a model or spatial group draw the
    same stride (``parallel.multihost.global_batch_dict``). ``rows`` and a
    ``process_count`` above 1 exclude each other."""

    def __init__(self, samples: Sequence[Tuple[str, int]], batch_size: int,
                 combo_ids: Optional[Sequence[int]] = None, shuffle: bool = False,
                 seed: int = 0, num_workers: int = DECODE_WORKERS,
                 draw_key: Optional[Sequence[int]] = None,
                 rows: Optional[Sequence[int]] = None, process_index: int = 0,
                 process_count: int = 1):
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} is outside [0, {process_count})")
        if rows is not None and process_count > 1:
            raise ValueError("rows= (a rank's rows of every global batch) and a process "
                             "stride (process_count > 1) exclude each other")
        self.samples = list(samples)
        self.combo_ids = (list(combo_ids) if combo_ids is not None
                          else [0] * len(self.samples))
        if len(self.combo_ids) != len(self.samples):
            raise ValueError(f"{len(self.combo_ids)} combination ids for "
                             f"{len(self.samples)} samples")
        self.draw_key = tuple(draw_key) if draw_key is not None else None
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self._epoch = 0
        self._skip = 0
        self.rows = None if rows is None else np.asarray(rows, dtype=np.int64)
        self.process_index = int(process_index)
        self.process_count = int(process_count)

    def set_epoch(self, epoch: int) -> None:
        """The next ``__iter__`` gives the order of a fresh loader's
        ``epoch``-th iteration."""
        self._epoch = int(epoch)

    def set_position(self, epoch: int, skip_batches: int = 0) -> None:
        """Mid-epoch seek (resume): the next ``__iter__`` replays epoch
        ``epoch``'s order and drops its first ``skip_batches`` batches
        without decoding them; the tail padding comes from the full epoch
        order. Once only: the epochs after it start at batch 0."""
        self.set_epoch(epoch)
        self._skip = int(skip_batches)

    def _local_n(self) -> int:
        """This process's sample count after the global padding."""
        n = len(self.samples)
        if self.process_count == 1:
            return n
        chunk = self.process_count * self.batch_size
        return -(-n // chunk) * chunk // self.process_count

    def __len__(self):
        return (self._local_n() + self.batch_size - 1) // self.batch_size

    def _order(self) -> Tuple[np.ndarray, np.ndarray]:
        """(this process's sample indices, their validity) for this epoch."""
        n = len(self.samples)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        valid = np.ones(n, dtype=bool)
        if self.process_count > 1:
            total = self._local_n() * self.process_count
            if total > n:  # pad by cycling from the start of the global order
                order = np.concatenate([order, order[np.arange(total - n) % n]])
                valid = np.concatenate([valid, np.zeros(total - n, dtype=bool)])
            order = order[self.process_index::self.process_count]
            valid = valid[self.process_index::self.process_count]
        return order, valid

    def __iter__(self) -> Iterator[dict]:
        order, order_valid = self._order()
        epoch = self._epoch
        self._epoch += 1
        bs = self.batch_size
        batches: List[Tuple[int, Tuple[np.ndarray, np.ndarray]]] = list(
            enumerate((order[i : i + bs], order_valid[i : i + bs])
                      for i in range(0, len(order), bs)))
        skip, self._skip = self._skip, 0
        batches = batches[skip:]

        # separate pools, so an assembler waiting on decodes never starves them
        decode_pool = cf.ThreadPoolExecutor(max_workers=self.num_workers)
        batch_pool = cf.ThreadPoolExecutor(max_workers=PREFETCH_BATCHES)

        rows = self.rows if self.rows is not None else np.arange(bs)

        def make_batch(index: int, part: Tuple[np.ndarray, np.ndarray]) -> dict:
            idxs, valid = part
            n = len(idxs)
            if n < bs:  # pad by cycling samples from the start of the epoch order
                idxs = np.concatenate([idxs, order[np.arange(bs - n) % len(order)]])
                valid = np.concatenate([valid, np.zeros(bs - n, dtype=bool)])
            labels = np.full((bs,), -1, dtype=np.int32)
            labels[valid] = [self.samples[i][1] for i in idxs[valid]]
            idxs, labels = idxs[rows], labels[rows]
            imgs = np.empty((len(idxs), STAGING_SIZE, STAGING_SIZE, 3), dtype=np.uint8)
            decoded = decode_pool.map(lambda i: load_image_staged(self.samples[i][0]), idxs)
            for j, arr in enumerate(decoded):
                imgs[j] = arr
            combos = np.asarray([self.combo_ids[i] for i in idxs], dtype=np.int32)
            batch = {"image": imgs, "label": labels, "combo": combos,
                     "indices": np.asarray(idxs), "n_valid": int(valid.sum())}
            if self.draw_key is not None:
                from .augment import batch_draws

                batch["mix_key"] = self.draw_key + (epoch, index)
                batch["draws"] = batch_draws(batch["mix_key"], bs)[rows]
            return batch

        pending = []
        try:
            for index, part in batches:
                pending.append(batch_pool.submit(make_batch, index, part))
                if len(pending) >= PREFETCH_BATCHES:
                    yield pending.pop(0).result()
            while pending:
                yield pending.pop(0).result()
        finally:
            batch_pool.shutdown(wait=False, cancel_futures=True)
            decode_pool.shutdown(wait=False, cancel_futures=True)
