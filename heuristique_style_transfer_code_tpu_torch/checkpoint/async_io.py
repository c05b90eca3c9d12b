"""Checkpoint writes in a background thread (``checkpoint/async_io.py:54-144``
of the JAX package): training does not wait on the disk.

``submit`` takes a host copy of every tensor and array of the tree before
it returns, so a later in-place update of the parameters or the Adam
moments cannot race the write; a ``sharded_io.Shard`` keeps its box and
copies only its block, and only where this rank owns it. One worker
thread then writes the files in FIFO order with ``save_pytree_npz``'s
atomic rename (``save_fn``: ``sharded_io.save_sharded_pytree`` for
``make_async_sharded_writer``). ``wait`` blocks
until everything submitted is on disk and re-raises the first error of the
worker; ``max_pending`` bounds the copies in flight by blocking
``submit``.
"""
from __future__ import annotations

import atexit
import queue
import threading
from typing import Any, Optional

import numpy as np
import torch

from .sharded_io import Shard


def _snapshot(tree: Any) -> Any:
    """A copy of ``tree`` that owns its buffers, on the host (a bfloat16
    tensor stays a tensor: numpy has no such type)."""
    if isinstance(tree, Shard):
        return tree.snapshot()
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_snapshot(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        t = tree.detach().to("cpu", copy=True)
        return t if t.dtype == torch.bfloat16 else t.numpy()
    if isinstance(tree, np.ndarray):
        return np.array(tree, copy=True)
    return tree  # python scalars and strings are immutable


class AsyncCheckpointWriter:
    """FIFO background writer of the files ``save_pytree_npz`` writes. Use
    as a context manager or call ``wait()``/``close()``."""

    def __init__(self, max_pending: int = 2, save_fn=None):
        self._save_fn = save_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, int(max_pending)))
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self._closed = False
        # flush pending writes when the process exits on an unhandled error
        atexit.register(self._atexit_close)

    def submit(self, tree: Any, path: str) -> None:
        """Snapshot ``tree`` and enqueue its write to ``path``; blocks only
        when ``max_pending`` writes are in flight."""
        if self._closed:
            raise RuntimeError("writer is closed")
        self._raise_pending()
        if not self._started:
            self._worker.start()
            self._started = True
        self._q.put((_snapshot(tree), path))

    def wait(self) -> None:
        """Block until every submitted checkpoint is on disk, then re-raise
        the first worker error, if any."""
        self._q.join()
        self._raise_pending()

    def close(self) -> None:
        """``wait()`` and stop the worker. Idempotent."""
        if self._closed:
            return
        try:
            self.wait()
        finally:
            self._closed = True
            if self._started:
                self._q.put(None)
                self._worker.join()
            atexit.unregister(self._atexit_close)

    def _atexit_close(self):
        try:
            self.close()
        except Exception:
            pass  # the interpreter is exiting; nothing to report to

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.close()
        else:  # flush, without masking the exception in flight
            self._atexit_close()

    def _raise_pending(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _run(self):
        from .io import save_pytree_npz

        save_fn = self._save_fn or save_pytree_npz
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                break
            tree, path = item
            try:
                save_fn(tree, path)
            except BaseException as e:  # surfaced at the next submit or wait
                if self._error is None:
                    self._error = e
            finally:
                self._q.task_done()
