"""Early stopping with best-epoch weight restoration
(``train/early_stop.py`` of the JAX package, ``--early_stop PATIENCE``).

``run_kfold`` validates after every epoch, stops a fold once
``patience`` consecutive epochs fail to improve the validation loss, and
restores the best epoch's weights before the fold-end evaluation and its
artifacts. The snapshot is a host copy in the JAX layout
(``checkpoint.convert.to_jax_tree``): the next epoch updates the model's
tensors in place. Counters and the snapshot ride the resume checkpoint, so
a resumed run stops at the same epoch.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np


class EarlyStopper:
    """Per-fold early-stopping state: strict-improvement tracking with a
    host snapshot of the best epoch's tree. ``update`` returns True when
    training should stop."""

    def __init__(self, patience: int):
        patience = int(patience)
        if patience < 1:
            raise ValueError("early-stop patience must be >= 1")
        self.patience = patience
        self.best_loss = float("inf")
        self.since = 0  # epochs since the last improvement
        self.best_epoch: Optional[int] = None
        self.best_variables: Any = None  # host (numpy) tree
        self.improved_last = False  # did the most recent update() improve?

    def update(self, val_loss: float, variables: Any, epoch: int) -> bool:
        """``variables``: the epoch's tree, a host copy the stopper keeps."""
        val_loss = float(val_loss)
        if val_loss < self.best_loss:
            self.best_loss = val_loss
            self.since = 0
            self.best_epoch = int(epoch)
            self.best_variables = variables
            self.improved_last = True
            return False
        self.improved_last = False
        self.since += 1
        return self.since >= self.patience

    def state_leaves(self) -> dict:
        """Counter leaves for the in-progress checkpoint (the best tree goes
        to its own file: it is a whole model)."""
        return {
            "es_best_loss": np.asarray(self.best_loss, np.float64),
            "es_since": np.asarray(self.since, np.int64),
            "es_best_epoch": np.asarray(-1 if self.best_epoch is None else self.best_epoch,
                                        np.int64),
        }

    def restore(self, leaves: dict, best_variables: Any) -> None:
        self.best_loss = float(np.asarray(leaves["es_best_loss"]))
        self.since = int(np.asarray(leaves["es_since"]))
        be = int(np.asarray(leaves["es_best_epoch"]))
        self.best_epoch = None if be < 0 else be
        self.best_variables = best_variables
        self.improved_last = False
