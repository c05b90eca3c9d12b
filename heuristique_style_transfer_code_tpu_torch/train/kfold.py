"""K-fold cross-validation with the reference's artifact set
(``train/kfold.py`` of the JAX package, ``run_kfold`` ``:137`` onward,
single host):

- the split of ``sklearn.model_selection.KFold(shuffle=True,
  random_state=seed)``, reproduced by ``kfold_split`` (scikit-learn is not
  needed);
- per fold: a fresh model (with the pretrained tree), training over the
  augmentation product (each train sample once per transform
  combination), evaluation;
- ``fold_<k>_performance.json``, ``best_model_fold_<k>.npz`` (kept across
  reruns through ``best_model_results.json`` while it stays the best),
  ``best_global_model.npz`` by validation loss, ``training_info.json``
  with the per-fold and averaged metrics, ``events.jsonl``, and the
  caller's ``on_fold_end`` hook (family 2's per-fold JSON files); family
  3's split seed of its own, ``model_fold_<k>.npz`` for every fold and its
  fold-results file (``:155-158``, ``:229-230``).

``--resume`` writes one atomic in-progress file per epoch (the model and
the optimiser state, its parameter EMA included, in the JAX layout, the
position and the run's signature) and a fold-boundary meta; an interrupted run continues from
the last completed epoch, bit-identically on the CPU. A SIGTERM stops it
before the next step with ``PreemptedError``.

Deviation from the JAX package's ``run_kfold``: each fold's fresh weights
come from ``torch.Generator().manual_seed(seed + fold)``, not from
``jax.random``, so the two packages start a fold from different weights
(the loader's shuffle is the same numpy one). Likewise each train batch's
augmentation parameters come from a CPU ``torch.Generator`` seeded from
(seed, fold, epoch, batch index) (``data/augment.batch_draws``), not from
the JAX run's key.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.convert import from_jax_tree, load_jax_tree, to_jax_tree
from ..checkpoint.io import load_pytree_npz, save_model_and_hyperparameters, save_pytree_npz
from ..data.loader import HostLoader
from .train_loop import evaluate, train_epochs

_INPROGRESS_STATE = "_inprogress_state.npz"
_INPROGRESS_META = "_inprogress_meta.json"
_INPROGRESS_BEST = "_inprogress_best.npz"  # early stopping's best-epoch weights


def kfold_split(n: int, k: int, seed: int) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``KFold(n_splits=k, shuffle=True, random_state=seed).split(range(n))``:
    ``np.random.RandomState(seed)`` shuffles 0..n-1, the shuffled order is
    cut into k contiguous folds (the first ``n % k`` one longer), and each
    fold's test and train indices come out sorted."""
    if k < 2 or n < k:
        raise ValueError(f"k-fold needs 2 <= k_folds <= samples, got k={k} with {n} samples")
    order = np.arange(n)
    np.random.RandomState(seed).shuffle(order)
    sizes = np.full(k, n // k, dtype=int)
    sizes[: n % k] += 1
    out, start = [], 0
    for size in sizes:
        mask = np.zeros(n, dtype=bool)
        mask[order[start:start + size]] = True
        out.append((np.arange(n)[~mask], np.arange(n)[mask]))
        start += size
    return out


def load_training_info(save_dir: str, filename: str):
    path = os.path.join(save_dir, filename)
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


def save_training_info(info, save_dir: str, filename: str) -> None:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, filename)
    with open(path, "w") as f:
        json.dump(info, f, indent=4)
    print(f"Training information saved to {path}")


def _run_signature(seed, k_folds, epochs, split_seed, hyperparameters, extra=None) -> str:
    """A run's identity, stored with every in-progress file and checked on
    resume (the JAX ``_run_signature``)."""
    d = {"seed": seed, "k_folds": k_folds, "epochs": epochs, "split_seed": split_seed,
         "hyperparameters": hyperparameters}
    if extra:
        d["extra"] = extra
    return json.dumps(d, sort_keys=True, default=str)


def _inprogress_tree(model, opt_state, fold, epochs_done, signature, extra_leaves=None):
    """One file per epoch: the model and the SGD state in the JAX layout,
    the position and the signature, so no crash can pair one epoch's
    weights with another's position. The port reads its own files."""
    opt = {"count": np.int64(opt_state["count"]),
           "trace": to_jax_tree(model, opt_state["trace"])}
    if "ema" in opt_state:
        opt["ema"] = to_jax_tree(model, opt_state["ema"])
    tree = {
        "variables": to_jax_tree(model),
        "opt": opt,
        "fold": int(fold),
        "epochs_done": int(epochs_done),
        "signature": np.asarray(signature),
    }
    if extra_leaves:
        tree.update(extra_leaves)
    return tree


def _restore(model, opt_state, st) -> None:
    """The in-progress file's model and SGD state (with its EMA) into
    ``model`` and ``opt_state``, in place."""
    load_jax_tree(model, st["variables"])
    with torch.no_grad():
        for part in ("trace", "ema"):
            if part in opt_state:
                for name, t in from_jax_tree(st["opt"][part]).items():
                    opt_state[part][name].copy_(t)
    opt_state["count"] = int(np.asarray(st["opt"]["count"]))


def _save_inprogress_meta(save_dir, meta) -> None:
    tmp = os.path.join(save_dir, _INPROGRESS_META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=4)
    os.replace(tmp, os.path.join(save_dir, _INPROGRESS_META))


def _clear_inprogress(save_dir) -> None:
    for name in (_INPROGRESS_STATE, _INPROGRESS_META, _INPROGRESS_BEST):
        p = os.path.join(save_dir, name)
        if os.path.exists(p):
            os.unlink(p)


def run_kfold(
    dataset,
    *,
    k_folds: int,
    seed: int,
    epochs: int,
    batch_size: int,
    save_dir: str,
    hyperparameters: dict,
    init_fn: Callable[[int], tuple],
    combos_per_sample: int = 1,
    writer=None,
    save_fn: Optional[Callable] = None,
    kfold_random_state: Optional[int] = None,
    save_every_fold: bool = False,
    performance_filename: Optional[str] = None,
    steps_per_dispatch: int = 1,
    resume: bool = False,
    async_checkpoint: bool = False,
    foldwise_step: Optional[Callable] = None,
    signature_extra: Optional[Dict] = None,
    early_stop: Optional[int] = None,
    eval_variables_fn: Optional[Callable] = None,
    on_fold_end: Optional[Callable] = None,
) -> Dict:
    """The cross-validation protocol; returns training_info.

    ``init_fn(fold) -> (model, opt_state, train_step, eval_step)`` gives a
    fold's fresh model and optimiser state. Each train sample is taken
    once per combination, ``combos_per_sample`` times, with combination
    ids 0, 1, ... ``kfold_random_state`` seeds the split in
    place of ``seed``; ``save_every_fold`` writes ``model_fold_<k>`` after
    every fold; ``performance_filename`` gets the fold results' list.
    ``on_fold_end(fold, record,
    model_path)`` gets the retained record of the fold (this run's, or a
    better earlier run's whose checkpoint stays on disk). ``early_stop=P``
    validates every epoch, stops a fold after P epochs without a new best
    validation loss and evaluates and saves the best epoch's weights.
    Fold-parallel training (``foldwise_step``) is not ported yet."""
    from ..utils.logging import StructuredLogger
    from .preemption import clear_preemption, install_sigterm_handler

    if foldwise_step is not None:
        raise NotImplementedError("--parallel_folds (fold-parallel training) is not ported yet")
    os.makedirs(save_dir, exist_ok=True)
    logger = StructuredLogger(save_dir)
    split_seed = seed if kfold_random_state is None else kfold_random_state
    splits = kfold_split(len(dataset), k_folds, split_seed)
    num_classes = len(dataset.classes)

    fold_results: List[dict] = []
    best_model_results = load_training_info(save_dir, "best_model_results.json") or []
    best_performance = float("inf")
    best_global_path = None
    signature = _run_signature(seed, k_folds, epochs, split_seed, hyperparameters,
                               signature_extra)
    acw = None
    if resume and async_checkpoint:
        from ..checkpoint.async_io import AsyncCheckpointWriter

        acw = AsyncCheckpointWriter()
    clear_preemption()  # a stale request from an earlier run in this process
    if resume:
        install_sigterm_handler()
    resume_state, resume_fold, resume_epochs = None, None, 0
    if resume:
        meta = load_training_info(save_dir, _INPROGRESS_META)
        state_path = os.path.join(save_dir, _INPROGRESS_STATE)
        loaded = load_pytree_npz(state_path) if os.path.exists(state_path) else None
        for found in (meta.get("signature") if meta else None,
                      str(np.asarray(loaded["signature"])) if loaded is not None else None):
            if found is not None and found != signature:
                raise ValueError(
                    "--resume: this run's configuration does not match the "
                    "interrupted run's (seed/k_folds/epochs/split/"
                    f"hyperparameters differ).\n  was: {found}\n  now: {signature}"
                )
        if meta is not None or loaded is not None:
            if meta is not None:
                fold_results = list(meta["fold_results"])
                best_model_results = list(meta.get("best_model_results", []))
                best_global_path = meta.get("best_global_path")
            if fold_results:
                best_performance = min(r["val_loss"] for r in fold_results)
            resume_fold = len(fold_results)
            # a state from a fold the meta already holds is stale: that
            # fold is done, the next one starts fresh
            if loaded is not None and int(np.asarray(loaded["fold"])) == resume_fold:
                resume_state = loaded
                resume_epochs = int(np.asarray(loaded["epochs_done"]))
            print(f"Resuming from fold {resume_fold}, epoch {resume_epochs}")

    training_info = load_training_info(save_dir, "training_info.json") or {
        "num_classes": num_classes,
        "class_names": dataset.classes,
        "num_samples_per_class": dataset.samples_per_class(),
        "total_num_samples": len(dataset),
        "num_epochs": epochs,
        "num_folds": k_folds,
        "fold_results": [],
    }
    if resume_fold is not None:
        training_info["fold_results"].extend(
            {"fold": i, **r} for i, r in enumerate(fold_results))
    if save_fn is None:
        save_fn = save_model_and_hyperparameters

    def _eval_model(m, o):
        return eval_variables_fn(m, o) if eval_variables_fn is not None else m

    try:
        for fold, (train_idx, val_idx) in enumerate(splits):
            if resume_fold is not None and fold < resume_fold:
                continue  # done; its results were restored above
            print(f"FOLD {fold}")
            val_loader = HostLoader([dataset.samples[i] for i in val_idx], batch_size)
            # the augmentation product: each train sample x each combination
            train_samples, combo_ids = [], []
            for i in train_idx:
                for c in range(combos_per_sample):
                    train_samples.append(dataset.samples[i])
                    combo_ids.append(c)
            train_loader = HostLoader(train_samples, batch_size, combo_ids=combo_ids,
                                      shuffle=True, seed=seed + fold, draw_key=(seed, fold))
            model, opt_state, train_step, eval_step = init_fn(fold)

            stopper = None
            if early_stop is not None:
                from .early_stop import EarlyStopper

                stopper = EarlyStopper(early_stop)
            start_epoch = 0
            if resume_state is not None and fold == resume_fold and resume_epochs > 0:
                _restore(model, opt_state, resume_state)
                start_epoch = resume_epochs
                train_loader.set_epoch(start_epoch)
                if stopper is not None and "es_best_loss" in resume_state:
                    best_path = os.path.join(save_dir, _INPROGRESS_BEST)
                    best_v = (load_pytree_npz(best_path)["variables"]
                              if os.path.exists(best_path) else None)
                    stopper.restore(resume_state, best_v)

            on_epoch_end = None
            if resume or stopper is not None:

                def on_epoch_end(epoch, m, o, _fold=fold, _stopper=stopper,
                                 _val_loader=val_loader, _eval_step=eval_step):
                    stop = False
                    if _stopper is not None:
                        ev = _eval_model(m, o)
                        r = evaluate(_eval_step, ev, _val_loader, num_classes, fold=_fold,
                                     writer=writer, step=epoch)
                        stop = _stopper.update(r["val_loss"], to_jax_tree(ev), epoch)
                        if resume and _stopper.improved_last:
                            # the best file before the counters: a crash in
                            # between reruns this epoch and rewrites it
                            save_pytree_npz({"variables": _stopper.best_variables},
                                            os.path.join(save_dir, _INPROGRESS_BEST))
                    if resume:
                        tree = _inprogress_tree(
                            m, o, _fold, epoch + 1, signature,
                            _stopper.state_leaves() if _stopper is not None else None)
                        path = os.path.join(save_dir, _INPROGRESS_STATE)
                        if acw is not None:
                            acw.submit(tree, path)
                        else:
                            save_pytree_npz(tree, path)
                    if stop:
                        print(f"Fold {_fold}: early stop after epoch {epoch + 1} (no val-loss "
                              f"improvement in {_stopper.patience} epoch(s); best "
                              f"{_stopper.best_loss:.4f} at epoch "
                              f"{(_stopper.best_epoch or 0) + 1})")
                    return stop

            model, opt_state = train_epochs(
                train_step, model, opt_state, train_loader, epochs, fold=fold, writer=writer,
                steps_per_dispatch=steps_per_dispatch,
                start_epoch=start_epoch, on_epoch_end=on_epoch_end, preemptible=resume)
            if stopper is not None and stopper.best_variables is not None:
                # the snapshot is already the evaluation model's (the EMA's)
                load_jax_tree(model, stopper.best_variables)
                print(f"Fold {fold}: restored best-epoch weights (epoch "
                      f"{stopper.best_epoch + 1}, val loss {stopper.best_loss:.4f})")
            else:
                model = _eval_model(model, opt_state)
            result = evaluate(eval_step, model, val_loader, num_classes, fold=fold,
                              writer=writer, step=max(epochs - 1, 0))
            fold_results.append(result)
            fold_result = {"fold": fold, **result}
            training_info["fold_results"].append(fold_result)
            logger.event("fold_result", **fold_result)

            fold_perf_path = os.path.join(save_dir, f"fold_{fold}_performance.json")
            with open(fold_perf_path, "w") as f:
                json.dump(fold_result, f, indent=4)
            print(f"Fold {fold} performance saved to {fold_perf_path}")

            variables = to_jax_tree(model)
            if save_every_fold:
                fold_model_path = save_fn(variables, hyperparameters, save_dir,
                                          f"model_fold_{fold}")
                print(f"Fold {fold}: Poids du modèle sauvegardés à {fold_model_path}")
            if result["val_loss"] < best_performance:
                best_performance = result["val_loss"]
                best_global_path = save_fn(variables, hyperparameters, save_dir,
                                           "best_global_model")
            prev = next((m for m in best_model_results if m["fold"] == fold), None)
            if prev is None or result["val_loss"] < prev["val_loss"]:
                model_path = save_fn(variables, hyperparameters, save_dir,
                                     f"best_model_fold_{fold}")
                best_model_results = [m for m in best_model_results if m["fold"] != fold]
                best_model_results.append({"fold": fold, "model_path": model_path, **result})
            else:
                model_path = prev["model_path"]
            if on_fold_end is not None:
                # the retained record describes the checkpoint on disk
                retained = next(m for m in best_model_results if m["fold"] == fold)
                on_fold_end(fold, retained, model_path)
            if resume:
                _save_inprogress_meta(save_dir, {
                    "fold_results": fold_results,
                    "best_model_results": best_model_results,
                    "best_global_path": best_global_path,
                    "signature": signature,
                })
            del model, opt_state
    finally:
        if acw is not None:
            acw.close()  # drain, so no pending write lands after the cleanup below

    # the reference's key names: avg_val_loss keeps its prefix, the others drop it
    avg = {
        "avg_val_loss": float(np.mean([r["val_loss"] for r in fold_results])),
        "avg_accuracy": float(np.mean([r["val_accuracy"] for r in fold_results])),
        "avg_precision": float(np.mean([r["val_precision"] for r in fold_results])),
        "avg_recall": float(np.mean([r["val_recall"] for r in fold_results])),
        "avg_f1": float(np.mean([r["val_f1"] for r in fold_results])),
    }
    training_info["average_results"] = dict(avg)
    print(
        "Average Validation Loss: {:.4f}, Accuracy: {:.4f}, Precision: {:.4f}, "
        "Recall: {:.4f}, F1 Score: {:.4f}".format(
            avg["avg_val_loss"], avg["avg_accuracy"], avg["avg_precision"],
            avg["avg_recall"], avg["avg_f1"],
        )
    )
    logger.event("average_results", **training_info["average_results"])
    logger.close()
    if performance_filename:
        with open(os.path.join(save_dir, performance_filename), "w") as f:
            json.dump([{"fold": i, **r} for i, r in enumerate(fold_results)], f, indent=4)
    save_training_info(training_info, save_dir, "training_info.json")
    save_training_info(best_model_results, save_dir, "best_model_results.json")
    _clear_inprogress(save_dir)
    if best_global_path:
        print(f"Best global model saved at {best_global_path} "
              f"with validation loss: {best_performance:.4f}")
    return training_info
