"""K loader batches per host round trip (``--steps_per_dispatch`` of the
evaluation CLIs; the JAX ``core/mesh.scanned_eval_iter``, ``:120-140``).

JAX stacks K batches, runs the per-batch program as one on-device scan and
fetches the K outputs at once. Here a chunk of K batches is stacked on the
host and uploaded once, the K per-batch steps are launched back to back
with no host read between them, and their outputs are stacked on the
device and fetched with one copy. Each batch's step is the K = 1 step, so
every per-batch output is the same; the final remainder goes one batch at
a time.
"""
from __future__ import annotations

from typing import Callable, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch


def _upload(arrays, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arrays)).to(device)


def dispatched_eval_iter(
    step: Callable[..., torch.Tensor],
    loader: Iterable[dict],
    device: torch.device,
    *,
    input_keys: Sequence[str] = ("image",),
    steps_per_dispatch: int = 1,
) -> Iterator[Tuple[dict, np.ndarray]]:
    """Drive ``step(*inputs) -> one device tensor`` over the loader's
    batches (``inputs``: the batch's ``input_keys`` on ``device``) and
    yield ``(batch, output as numpy)``, K = ``steps_per_dispatch`` batches
    per upload and fetch. Run it under ``torch.inference_mode()``."""
    k = max(1, int(steps_per_dispatch))

    def one(batch):
        return step(*(_upload(np.asarray(batch[key]), device) for key in input_keys))

    def flush(pending):
        if len(pending) == k > 1:
            stacked = [_upload(np.stack([np.asarray(b[key]) for b in pending]), device)
                       for key in input_keys]
            outs = torch.stack([step(*(s[t] for s in stacked)) for t in range(k)])
            outs = outs.cpu().numpy()
            yield from zip(pending, outs)
        else:
            for b in pending:
                yield b, one(b).cpu().numpy()

    pending = []
    for batch in loader:
        pending.append(batch)
        if len(pending) == k:
            yield from flush(pending)
            pending = []
    if pending:
        yield from flush(pending)
