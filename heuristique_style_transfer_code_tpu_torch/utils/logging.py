"""Structured JSONL events beside the console prints (``utils/logging.py``
of the JAX package, ``StructuredLogger``): ``run_kfold`` writes each
fold's result and the average to ``<save_dir>/events.jsonl``; and the
``--profile_dir`` trace (``maybe_profile``)."""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional


class StructuredLogger:
    """Appends one JSON record an event to <dir>/events.jsonl."""

    def __init__(self, save_dir: Optional[str] = None):
        self._fh = None
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self._fh = open(os.path.join(save_dir, "events.jsonl"), "a")

    def event(self, kind: str, **fields):
        if self._fh is not None:
            rec = {**fields, "t": time.time(), "kind": kind}
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None


@contextlib.contextmanager
def maybe_profile(profile_dir: Optional[str]):
    """``--profile_dir`` (the JAX ``maybe_profile``, ``:49-62``, and
    ``cli/_common.start_profile``): the block runs under ``torch.profiler``
    with the CPU activity and, where there is a card, the CUDA one, and its
    Chrome trace (``<host>_<pid>.<ms>.pt.trace.json``, viewable in
    Perfetto or TensorBoard) is written into the directory when the block
    ends; a no-op without a directory."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
            yield
    finally:
        print(f"Profiler trace written to {profile_dir}")
