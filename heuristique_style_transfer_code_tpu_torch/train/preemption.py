"""Preemption-safe training (``train/preemption.py`` of the JAX package):
SIGTERM sets a flag, the training loop checks it at the next batch
boundary, checkpoints the exact position and raises
:class:`PreemptedError`, which the CLI turns into a clean exit with the
resume hint."""
from __future__ import annotations

import signal
import threading

_PREEMPT = threading.Event()


class PreemptedError(RuntimeError):
    """Raised at a safe point after a preemption request; the progress is
    on disk, rerun with --resume."""

    def __init__(self, fold: int, epochs_done: int, message: str = None):
        self.fold = int(fold)
        self.epochs_done = int(epochs_done)
        super().__init__(
            message
            or f"preempted: progress through epoch {self.epochs_done} of fold "
            f"{self.fold} is checkpointed; rerun with --resume to continue"
        )


def request_preemption(signum=None, frame=None) -> None:
    """Signal-handler-compatible; also callable directly."""
    _PREEMPT.set()


def preemption_requested() -> bool:
    return _PREEMPT.is_set()


def clear_preemption() -> None:
    _PREEMPT.clear()


def install_sigterm_handler() -> bool:
    """Route SIGTERM to ``request_preemption``; False off the main thread
    (the flag can still be set directly)."""
    try:
        signal.signal(signal.SIGTERM, request_preemption)
        return True
    except ValueError:
        return False
