"""Structured JSONL events beside the console prints (``utils/logging.py``
of the JAX package, ``StructuredLogger``): ``run_kfold`` writes each
fold's result and the average to ``<save_dir>/events.jsonl``."""
from __future__ import annotations

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
