"""Embedding extraction over a loader (``tasks/embeddings.py`` of the JAX
package; the reference's functions_RESNET50_Truncate.py:391-420, with the
image paths taken from the loader's own sample order, once each).

One loop on the model's device: a batch's staged uint8 goes up once,
``eval_preprocess`` and ``embed_fn`` run there, the embeddings come back in
one fetch a batch (as float32: numpy has no bfloat16), or K batches a
round trip with ``steps_per_dispatch`` K (``core/dispatch.py``)."""
from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from ..core.device import device_of
from ..core.dispatch import dispatched_eval_iter
from ..data.augment import eval_preprocess


def compute_embeddings_with_paths(
    embed_fn: Callable,
    model,
    loader,
    samples,
    mesh=None,
    steps_per_dispatch: int = 1,
) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """``embed_fn(model, images)`` -> embeddings over every ``HostLoader``
    batch, pad rows trimmed (``n_valid``). Returns (embeddings (N, D),
    labels (N,), img_paths) in the loader's sample order, the same for
    any ``steps_per_dispatch``. A data-parallel ``mesh`` is not ported
    yet."""
    if mesh is not None:
        raise NotImplementedError("a data-parallel mesh is not ported yet")
    all_emb, all_labels, img_paths = [], [], []

    def step(images_u8):
        return embed_fn(model, eval_preprocess(images_u8)).float()

    with torch.inference_mode():
        for batch, emb in dispatched_eval_iter(step, loader, device_of(model),
                                               steps_per_dispatch=steps_per_dispatch):
            n = batch["n_valid"]
            all_emb.append(emb[:n])
            all_labels.append(np.asarray(batch["label"])[:n])
            img_paths.extend(samples[i][0] for i in batch["indices"][:n])
    return np.concatenate(all_emb), np.concatenate(all_labels), img_paths
