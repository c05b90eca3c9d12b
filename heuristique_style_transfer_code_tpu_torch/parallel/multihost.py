"""Starting the ranks of a data-parallel run (``parallel/multihost.py`` of
the JAX package, which wraps ``jax.distributed.initialize``).

- ``initialize_distributed`` joins this process to the process group:
  from explicit arguments, or from the ``RANK``, ``WORLD_SIZE`` (and
  ``MASTER_ADDR``/``MASTER_PORT``, or ``HST_DIST_INIT_METHOD``) that
  ``torchrun`` or ``launch`` set. NCCL for cards (each rank on card
  ``LOCAL_RANK``), gloo for the CPU. A CUDA run whose NCCL cannot start
  raises; nothing falls back to gloo or to the CPU.
- ``launch`` is what a train CLI's ``--devices N`` runs: N ranks with the
  ``spawn`` start method (CUDA cannot be forked), each calling the CLI's
  ``main`` with the same arguments and joining through a ``file://``
  rendezvous in a private temporary directory. The launching process
  forwards SIGTERM to every rank; if a rank fails, it ends the others and
  exits non-zero; once one rank has finished, the others get the
  collective timeout plus a minute to finish too.
- Under ``torchrun`` the CLI joins the group instead of spawning.
- ``make_global_batch`` and ``global_batch_dict`` (JAX ``:59-75``, which
  assemble each host's rows into one global ``jax.Array``): a port step
  takes each rank's own rows of the global batch, so these only check the
  rows (every data rank holds B_local of them: B_global = B_local times
  the data axis's size, in data-rank order) and put them on the rank's
  device. With ``HostLoader(process_index=mesh.data_index,
  process_count=mesh.data_axis.world_size)`` a step on them is the
  one-device step on the local batches concatenated in data-rank order.

Only rank 0 prints: ``quiet_unless_main`` sends the other ranks' standard
output to ``os.devnull`` (their errors still reach standard error).
"""
from __future__ import annotations

import os
import shutil
import signal
import sys
import tempfile
import time
from typing import Optional, Sequence

INIT_METHOD_ENV = "HST_DIST_INIT_METHOD"
GRACE_S = 10.0


def in_process_group_env() -> bool:
    """Whether a launcher (``launch``, ``torchrun``) made this process a
    rank: ``RANK`` and ``WORLD_SIZE`` are set."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def initialize_distributed(rank: Optional[int] = None, world_size: Optional[int] = None,
                           init_method: Optional[str] = None,
                           backend: Optional[str] = None) -> int:
    """Join the process group once; returns this process's rank. Missing
    arguments come from the environment (``RANK``, ``WORLD_SIZE``,
    ``HST_DIST_INIT_METHOD``, else ``env://`` with ``MASTER_ADDR`` and
    ``MASTER_PORT``); ``backend`` is gloo unless given. "nccl" puts this
    rank on card ``LOCAL_RANK`` (``torch.cuda.set_device``) first, and
    raises where NCCL is missing. The group's timeout is
    ``core.mesh.collective_timeout()``."""
    import torch
    import torch.distributed as dist

    from ..core.mesh import collective_timeout

    if dist.is_initialized():
        return dist.get_rank()
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else int(world_size)
    init_method = init_method or os.environ.get(INIT_METHOD_ENV) or "env://"
    backend = backend or "gloo"
    if backend == "nccl":
        if not (torch.cuda.is_available() and dist.is_nccl_available()):
            raise RuntimeError("NCCL is not available on this host: a CUDA data-parallel run "
                               "needs it (pass --device cpu for gloo on the CPU)")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=collective_timeout())
    return rank


def shutdown_distributed() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def quiet_unless_main(rank: int) -> None:
    """Rank 0 prints; every other rank's standard output goes to
    ``os.devnull``."""
    if rank != 0:
        sys.stdout = open(os.devnull, "w")


def _rank_main(rank: int, world: int, init_method: str, module: str,
               argv: Sequence[str]) -> None:
    """A spawned rank: the launcher's environment, then ``module.main``
    (which joins the group, ``cli/_common.build_mesh``)."""
    import importlib

    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                       INIT_METHOD_ENV: init_method})
    try:
        importlib.import_module(module).main(list(argv))
    finally:
        shutdown_distributed()


def launch(n: int, module: Optional[str], argv: Sequence[str], target=None,
           target_args: tuple = (), rendezvous_dir: Optional[str] = None,
           deadline_s: Optional[float] = None) -> None:
    """Run ``module.main(argv)`` in ``n`` spawned ranks (or ``target(rank,
    n, init_method, *target_args)``); return when all exit 0, else raise
    ``SystemExit`` with a non-zero code after ending the rest. The
    ``file://`` rendezvous lives in ``rendezvous_dir`` (a fresh temporary
    directory by default, removed at the end); ``deadline_s`` ends the
    ranks and fails the run when they are not all done by then."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="hst_dp_", dir=rendezvous_dir)
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    if target is None:
        procs = [ctx.Process(target=_rank_main, args=(r, n, init_method, module, list(argv)))
                 for r in range(n)]
    else:
        procs = [ctx.Process(target=target, args=(r, n, init_method) + tuple(target_args))
                 for r in range(n)]

    def forward_sigterm(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, forward_sigterm)
    except ValueError:  # not the main thread: no forwarding
        pass
    try:
        for p in procs:
            p.start()
        code = _watch(procs, None if deadline_s is None else time.monotonic() + deadline_s)
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
        _end(procs)
        shutil.rmtree(tmp, ignore_errors=True)
    if code:
        raise SystemExit(code)


def _watch(procs, hard_deadline: Optional[float] = None) -> int:
    """0 once every rank exited 0; else the first failing rank's code (1
    for a signal), the others ended."""
    from ..core.mesh import collective_timeout

    deadline = None
    while True:
        if hard_deadline is not None and time.monotonic() > hard_deadline:
            print("data-parallel run: the ranks missed their deadline", file=sys.stderr)
            return 1
        codes = [p.exitcode for p in procs]
        failed = [c for c in codes if c not in (None, 0)]
        if failed:
            print(f"data-parallel run: a rank exited with code {failed[0]}; ending the others",
                  file=sys.stderr)
            return failed[0] if failed[0] > 0 else 1
        if all(c == 0 for c in codes):
            return 0
        if deadline is None and any(c == 0 for c in codes):
            deadline = time.monotonic() + collective_timeout().total_seconds() + 60.0
        if deadline is not None and time.monotonic() > deadline:
            print("data-parallel run: a rank outlived the others by the collective timeout",
                  file=sys.stderr)
            return 1
        time.sleep(0.05)


def _end(procs) -> None:
    """SIGTERM to the ranks still running, then SIGKILL after a grace
    period (ranks that never started are skipped)."""
    procs = [p for p in procs if p.pid is not None]
    for p in procs:
        if p.is_alive():
            p.terminate()
    stop = time.monotonic() + GRACE_S
    for p in procs:
        p.join(max(0.0, stop - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5.0)


def _mesh_of(where):
    """The mesh itself, or the one a ``parallel.sharding.batch_sharding``/
    ``image_sharding`` cut carries."""
    return where.mesh if callable(where) else where


def make_global_batch(local, mesh):
    """This rank's rows (B_local, ...) of the global batch, a tensor on
    ``mesh``'s device (``mesh``: a ``core.mesh.Mesh`` or a sharding cut
    that carries one; None: the rows as a tensor). The port's steps take
    each rank's own rows, so nothing is assembled; on a process group
    every data rank must hold as many rows (one all-gather of the count
    over the data axis), else ValueError. A step on a spatial axis cuts
    the band of the rows itself."""
    import numpy as np
    import torch

    mesh = _mesh_of(mesh)
    rows = local if torch.is_tensor(local) else torch.as_tensor(np.asarray(local))
    if mesh is None:
        return rows
    rows = rows.to(mesh.device)
    if mesh.distributed:
        counts = mesh.data_axis.all_gather(torch.tensor([rows.shape[0]], device=mesh.device))
        counts = [int(c.item()) for c in counts]
        if len(set(counts)) != 1:
            raise ValueError(f"the data ranks hold {counts} rows: a global batch needs as many "
                             "on each (B_global = B_local x the data axis's size)")
    return rows


def global_batch_dict(batch: dict, image_sharding, batch_sharding) -> dict:
    """A ``HostLoader`` batch's "image", "label" and "combo" as this rank's
    rows of the global batch (``make_global_batch``; one check of the row
    count, on the images), on its device."""
    import numpy as np
    import torch

    image = make_global_batch(batch["image"], image_sharding)
    mesh = _mesh_of(batch_sharding)
    out = {"image": image}
    for key in ("label", "combo"):
        t = torch.as_tensor(np.asarray(batch[key]))
        if t.shape[0] != image.shape[0]:
            raise ValueError(f"{t.shape[0]} {key}s for {image.shape[0]} images")
        out[key] = t if mesh is None else t.to(mesh.device)
    return out
