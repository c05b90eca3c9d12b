"""K loader batches per host round trip (``--steps_per_dispatch`` of the
evaluation CLIs; the JAX ``core/mesh.scanned_eval_iter``, ``:120-140``).

JAX stacks K batches, runs the per-batch program as one on-device scan and
fetches the K outputs at once. Here a chunk of K batches is stacked on the
host and uploaded once, the K per-batch steps are launched back to back
with no host read between them, and their outputs are stacked on the
device and fetched with one copy. Each batch's step is the K = 1 step, so
every per-batch output is the same; the final remainder goes one batch at
a time.

On a data-parallel mesh each rank's loader holds its rows of every batch
(``HostLoader(rows=)``): the rank runs the step on them and the outputs,
labels and sample indices of the K batches come back to every rank as the
global batches (``core.mesh.gather_valid``, one gather a chunk), so the
caller sees what the one-device loop yields.
"""
from __future__ import annotations

import time
from typing import Callable, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from .mesh import data_parallel, gather_valid

# the per-batch keys that a caller reads beside the output; on a mesh they
# are gathered with it
_GATHERED = ("label", "indices")


def _upload(arrays, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arrays)).to(device)


def dispatched_eval_iter(
    step: Callable[..., torch.Tensor],
    loader: Iterable[dict],
    device: torch.device,
    *,
    input_keys: Sequence[str] = ("image",),
    steps_per_dispatch: int = 1,
    mesh=None,
    on_span: Optional[Callable[[float, dict], None]] = None,
) -> Iterator[Tuple[dict, np.ndarray]]:
    """Drive ``step(*inputs) -> one device tensor`` over the loader's
    batches (``inputs``: the batch's ``input_keys`` on ``device``) and
    yield ``(batch, output as numpy)``, K = ``steps_per_dispatch`` batches
    per upload and fetch. On a data-parallel ``mesh`` the yielded batch
    holds the global batch's "label", "indices" and "n_valid", and the
    output its rows of every rank. ``on_span(seconds, batch)`` (K = 1):
    each batch's time from its upload to its (gathered) output on the
    host. Run it under ``torch.inference_mode()``."""
    k = max(1, int(steps_per_dispatch))
    dp = data_parallel(mesh)
    if on_span is not None and k > 1:
        raise ValueError("per-batch spans need steps_per_dispatch=1")

    def gathered(chunk, outs):
        """(global batches, their outputs) of a chunk whose outputs are
        stacked (len(chunk), b, ...)."""
        if dp is None:
            return chunk, list(outs.cpu().numpy())
        keys = [key for key in _GATHERED if key in chunk[0]]
        flat = [outs.reshape((-1,) + tuple(outs.shape[2:]))]
        flat += [np.concatenate([np.asarray(b[key]) for b in chunk]) for key in keys]
        parts = gather_valid(dp, flat, n_accum=len(chunk))
        n = len(chunk)
        parts = [p.reshape((n, -1) + p.shape[1:]) for p in parts]
        batches = [{"n_valid": b["n_valid"], **{key: parts[1 + j][i] for j, key in
                                                enumerate(keys)}} for i, b in enumerate(chunk)]
        return batches, list(parts[0])

    def one(batch):
        t0 = time.perf_counter()
        out = step(*(_upload(np.asarray(batch[key]), device) for key in input_keys))
        (batch,), (out,) = gathered([batch], out[None])
        if on_span is not None:
            on_span(time.perf_counter() - t0, batch)
        return batch, out

    def flush(pending):
        if len(pending) == k > 1:
            stacked = [_upload(np.stack([np.asarray(b[key]) for b in pending]), device)
                       for key in input_keys]
            outs = torch.stack([step(*(s[t] for s in stacked)) for t in range(k)])
            yield from zip(*gathered(pending, outs))
        else:
            for b in pending:
                yield one(b)

    pending = []
    for batch in loader:
        pending.append(batch)
        if len(pending) == k:
            yield from flush(pending)
            pending = []
    if pending:
        yield from flush(pending)
