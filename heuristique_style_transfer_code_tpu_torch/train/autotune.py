"""Batch-size autotuning for the train step (``--auto_batch``;
``train/autotune.py`` of the JAX package).

Probe a doubling ladder of batch sizes from the configured one and adopt
the largest whose train step's peak memory fits the budget
(``autotune_batch``). The JAX package reads that peak from XLA's
compile-time memory analysis; eager PyTorch has none, so
``train_step_peak_bytes`` measures it:

- on the card, a real step: the setup's model and optimiser state built
  fresh at the candidate batch, one train step on zero staged uint8
  images, and the allocator's peak (``torch.cuda.max_memory_allocated``
  after ``reset_peak_memory_stats``); then everything is freed and the
  cache emptied. A ``torch.cuda.OutOfMemoryError`` is that probe's miss
  (JAX's "compile refused the allocation");
- on the CPU, which has no allocator peak, an estimate: the bytes of the
  parameters, their gradients, the optimiser state and the staged batch,
  plus the unique storages that autograd saves in one step (counted
  through ``torch.autograd.graph.saved_tensors_hooks``).

Both grow with the batch, so the search stops at the first miss. Neither
touches the run's own model, its batch-norm statistics or the generator
its initialisation draws from: each probe builds its own model from a
generator of its own.

On a data-parallel mesh (``--devices N``) the candidates are multiples of
N (``batch_candidates(divisor=N)``, JAX ``:80-92``), each rank probes the
data-parallel step at its B / N rows, in step with the others (the step
runs collectives), and the peak is the ranks' largest, so every rank
adopts the same batch.
"""
from __future__ import annotations

import gc
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

GIB = float(1 << 30)


def device_hbm_bytes(device="cuda") -> Optional[int]:
    """The device's memory in bytes: the card's total memory, or None on
    the CPU (which then needs ``--hbm_budget_gb``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return int(torch.cuda.get_device_properties(device).total_memory)


def _probe_batch(batch: int, canvas: int, device):
    from ..data.augment import N_DRAWS

    return (torch.zeros((batch, canvas, canvas, 3), dtype=torch.uint8, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device),
            np.zeros((batch,), np.int32), np.zeros((batch, N_DRAWS), np.float32))


def _storage_bytes(tensors) -> int:
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[s.data_ptr()] = s.nbytes()
    return sum(seen.values())


def train_step_peak_bytes(setup, batch: int, canvas: int, device="cuda", mesh=None) -> int:
    """Peak bytes of one train step of ``setup`` (a ``FamilySetup``) at
    ``batch`` on ``device``, on staged ``canvas``² uint8 images: the
    allocator's peak on the card, the estimate described above on the
    CPU. On a data-parallel ``mesh`` the global ``batch``'s step, the
    largest peak of the ranks (module docstring)."""
    from ..core.mesh import data_parallel

    dp = data_parallel(mesh)
    if dp is not None:
        return int(dp.max(train_step_peak_bytes(setup, batch // dp.world_size, canvas, device)))
    device = torch.device(device)
    mix_key = (0, 0, 0, 0)
    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        model = opt_state = staged = None
        try:
            model, opt_state = setup.init(torch.Generator().manual_seed(0))
            images, labels, combos, draws = staged = _probe_batch(batch, canvas, device)
            setup.train_step(model, opt_state, images, labels, combos, draws, mix_key=mix_key)
            torch.cuda.synchronize(device)
            return int(torch.cuda.max_memory_allocated(device))
        finally:
            del model, opt_state, staged
            gc.collect()
            torch.cuda.empty_cache()

    model, opt_state = setup.init(torch.Generator().manual_seed(0))
    images, labels, combos, draws = _probe_batch(batch, canvas, device)
    params = list(model.parameters())
    owned = {p.untyped_storage().data_ptr() for p in params}
    owned.update(t.untyped_storage().data_ptr() for t in model.buffers())
    saved = []

    def pack(t):
        if t.untyped_storage().data_ptr() not in owned:
            saved.append(t)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        setup.train_step(model, opt_state, images, labels, combos, draws, mix_key=mix_key)
    trainable = [t for part in ("trace", "ema") for t in opt_state.get(part, {}).values()]
    state = _storage_bytes(list(model.parameters()) + list(model.buffers()) + trainable)
    grads = sum(t.nbytes for t in opt_state["trace"].values())
    return int(state + grads + images.nbytes + labels.nbytes + _storage_bytes(saved))


def batch_candidates(base: int, divisor: int = 1, max_batch: int = 4096) -> Tuple[int, ...]:
    """Doubling ladder from the configured batch upward: base, 2·base, ...
    ≤ max_batch, each rounded up to a multiple of ``divisor``."""
    assert base >= 1 and divisor >= 1
    out, b = [], base
    while b <= max_batch:
        c = int(math.ceil(b / divisor) * divisor)
        if not out or c > out[-1]:
            out.append(c)
        b *= 2
    return tuple(out)


def autotune_batch(
    measure: Callable[[int], int],
    budget_bytes: int,
    candidates: Sequence[int],
    safety: float = 0.95,
) -> Tuple[Optional[int], Dict[int, Optional[int]]]:
    """Largest candidate whose ``measure(batch)`` ≤ ``safety·budget``.

    Probes ascending and stops at the first miss (the peak grows with the
    batch). A probe that raises (on the card, out of memory) counts as a
    miss. Returns (chosen or None, {batch: peak bytes, or None where the
    probe raised}); chosen is None when even the smallest candidate does
    not fit."""
    chosen: Optional[int] = None
    report: Dict[int, Optional[int]] = {}
    limit = budget_bytes * safety
    for b in sorted(set(int(c) for c in candidates)):
        try:
            peak = int(measure(b))
        except Exception:
            report[b] = None
            break
        report[b] = peak
        if peak <= limit:
            chosen = b
        else:
            break
    return chosen, report


def describe_report(report: Dict[int, Optional[int]], budget_bytes: int,
                    safety: float = 0.95) -> str:
    lines = [
        f"HBM budget {budget_bytes / GIB:.2f} GiB "
        f"(safety margin {safety:.0%} -> {budget_bytes * safety / GIB:.2f} GiB usable)"
    ]
    for b in sorted(report):
        peak = report[b]
        if peak is None:
            lines.append(f"  batch {b}: compile refused the allocation")
        else:
            fits = "fits" if peak <= budget_bytes * safety else "over budget"
            lines.append(f"  batch {b}: peak {peak / GIB:.2f} GiB -> {fits}")
    return "\n".join(lines)
