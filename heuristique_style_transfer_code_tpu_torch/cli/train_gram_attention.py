"""Training CLI, family 2, on PyTorch — the flags of
``heuristique_style_transfer_code_tpu/cli/train_gram_attention.py`` (the
reference's ``train_best_RESNET50_Truncate_gram_attention.py``, with
``--freeze_layers``) plus ``--device`` (default ``cuda``; ``cpu`` when
asked).

K-fold cross-validation over ``--data``/train: per fold a fresh truncated
ResNet50 + pooled-Gram attention model (the ``--model_path`` encoder or
whole model loaded shape by shape; a family-1 checkpoint gives its
encoder), SGD with momentum 0.9 at the config's ``lr``, the masked
cross-entropy, evaluation, and the reference's artifacts in
``--save_dir``: ``best_performance_fold_<k>.json``,
``best_hyperparameters_fold_<k>.json``, ``fold_<k>_performance.json``,
``best_model_fold_<k>.npz``, ``best_global_model.npz`` (each with its
``_hyperparameters.json``), ``best_model_results.json``,
``training_info.json`` and ``events.jsonl``. The npz files are the JAX
package's layout, which the ``test_gram_attention`` CLI of either package
reads. ``--resume`` (with SIGTERM preemption, exit 0 and the resume hint),
``--async_checkpoint``, ``--lr_schedule``, ``--warmup_steps``,
``--min_lr_ratio``, ``--clip_grad_norm``, ``--label_smoothing``,
``--early_stop``, ``--tensorboard``, ``--precision float32|bf16``,
``--remat``, ``--grad_accum``, ``--steps_per_dispatch``, ``--profile_dir``,
``--debug_nans``, ``--ema_decay`` (every fold artifact from the weights'
EMA), ``--mixup``/``--cutmix`` (``train/mixing.py``) and ``--auto_batch``
with ``--hbm_budget_gb`` (``train/autotune.py``: on the CPU an estimate)
run;
the flags of ``cli/_common.TRAIN_NOT_PORTED`` and ``--devices`` other than
1 raise "not ported yet".

Each fold's fresh weights come from ``torch.Generator().manual_seed(seed +
fold)``, not from ``jax.random``: the two packages start a fold from
different weights.

    python -m heuristique_style_transfer_code_tpu_torch.cli.train_gram_attention \\
        --data datasets/weather --config_path cfg.json --k_folds 2 --epochs 1 \\
        --save_dir out [--freeze_layers] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

from ._common import add_device_args, add_train_args


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train truncated ResNet50 + Gram/attention head (PyTorch)")
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--model_path", type=str, help="Pre-trained encoder (.npz or .pth)")
    parser.add_argument("--epochs", default=25, type=int)
    parser.add_argument("--save_dir", default="saved_models_attention_gram_resnet50", type=str)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--k_folds", default=2, type=int)
    parser.add_argument("--freeze_layers", action="store_true", help="Freeze the encoder layers")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Train steps launched back to back per host read of their "
                        "losses: the same batches, draws, losses and weights as 1")
    add_device_args(parser)
    add_train_args(parser)
    return parser


def _load_pretrained(model_path: str, cfg, num_classes: int, hyperparameters: dict):
    """The checkpoint's tree (a family-1 one gives its encoder), with the
    JAX CLI's count of the tensors that match the architecture."""
    import torch

    from ..checkpoint.convert import to_jax_tree
    from ..checkpoint.pth_converter import shape_filtered_update
    from ..models.gram_attention import gram_attention_init
    from ._common import load_checkpoint_tree

    pretrained = load_checkpoint_tree(model_path, "gram_attention", hyperparameters)
    if "encoder" not in pretrained and isinstance(pretrained.get("moco"), dict):
        # a family-1 checkpoint: its encoder (the reference's load_model path)
        pretrained = {"encoder": pretrained["moco"].get("encoder", {})}
        print("Family-1 checkpoint detected: reusing its encoder only.")
    template = to_jax_tree(gram_attention_init(torch.Generator().manual_seed(0),
                                               cfg.truncate_layer, num_classes,
                                               cfg.gram_matrix_size, device="cpu"))
    stats: dict = {}
    shape_filtered_update(template, pretrained, stats)
    print(f"Poids du modèle chargés depuis {model_path} "
          f"({stats.get('loaded', 0)}/{stats.get('total', 0)} tensors matched)")
    if stats.get("loaded", 0) == 0:
        raise ValueError(f"No tensor in {model_path} matches the gram-attention "
                         "architecture — wrong checkpoint or config.")
    return pretrained


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ._common import check_train_ported

    check_train_ported(args)

    import torch

    from ..config.schema import GramAttentionConfig
    from ..core.device import resolve_device
    from ..data.imagefolder import ImageFolderIndex
    from ..train.factories import setup_gram_attention
    from ..train.kfold import run_kfold
    from ..train.preemption import PreemptedError
    from ._common import (
        _ema_eval_fn,
        apply_auto_batch,
        apply_grad_accum,
        make_save_fn,
        make_writer,
        resolve_compute_dtype,
        resolve_lr_schedule,
        resolve_mix_fn,
        resolve_seed,
        runtime_flags,
        signature_extra_from_args,
    )

    device = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)
    cfg = GramAttentionConfig.from_json(args.config_path)
    hyperparameters = cfg.to_dict()
    seed = resolve_seed(hyperparameters, args.seed)
    save_fn = make_save_fn(args.checkpoint_format)

    dataset = ImageFolderIndex(os.path.join(args.data, "train"))
    num_classes = len(dataset.classes)
    writer = make_writer(args.tensorboard, args.save_dir)
    combos = [(None, None)]

    pretrained = None
    if args.model_path:
        pretrained = _load_pretrained(args.model_path, cfg, num_classes, hyperparameters)

    lr_schedule, clip_norm = resolve_lr_schedule(args, cfg, len(dataset.samples), args.k_folds)
    setup = setup_gram_attention(
        cfg, num_classes, combos, pretrained=pretrained, freeze_encoder=args.freeze_layers,
        compute_dtype=resolve_compute_dtype(args.precision), lr_schedule=lr_schedule,
        clip_norm=clip_norm, label_smoothing=args.label_smoothing, ema_decay=args.ema_decay,
        mix_fn=resolve_mix_fn(args), remat=args.remat, device=device)
    apply_auto_batch(args, setup, cfg, hyperparameters, device)
    apply_grad_accum(args, setup, cfg.batch_size)

    def init_fn(fold):
        model, opt_state = setup.init(torch.Generator().manual_seed(seed + fold))
        return model, opt_state, setup.train_step, setup.eval_step

    def on_fold_end(fold, result, model_path):
        """The reference's per-fold files
        (train_best_RESNET50_Truncate_gram_attention.py:98-127):
        best_performance_fold_<k>.json (its evaluate's four metrics) and
        best_hyperparameters_fold_<k>.json (with the config's vestigial
        hidden_dims and num_layers and the fold checkpoint's path)."""
        perf_path = os.path.join(args.save_dir, f"best_performance_fold_{fold}.json")
        with open(perf_path, "w") as f:
            json.dump({"accuracy": result["val_accuracy"], "precision": result["val_precision"],
                       "recall": result["val_recall"], "val_loss": result["val_loss"]},
                      f, indent=4)
        print(f"Fold {fold} performance saved to {perf_path}")
        hp_path = os.path.join(args.save_dir, f"best_hyperparameters_fold_{fold}.json")
        with open(hp_path, "w") as f:
            json.dump({"hidden_dims": hyperparameters.get("hidden_dims"),
                       "num_layers": hyperparameters.get("num_layers"),
                       "batch_size": cfg.batch_size, "lr": cfg.lr,
                       "truncate_layer": cfg.truncate_layer,
                       "gram_matrix_size": cfg.gram_matrix_size,
                       "model_path": model_path}, f, indent=4)
        print(f"Fold {fold} hyperparameters saved to {hp_path}")

    try:
        with runtime_flags(args):
            run_kfold(
                dataset,
                k_folds=args.k_folds,
                seed=seed,
                epochs=args.epochs,
                batch_size=cfg.batch_size,
                save_dir=args.save_dir,
                hyperparameters=hyperparameters,
                init_fn=init_fn,
                save_fn=save_fn,
                writer=writer,
                steps_per_dispatch=args.steps_per_dispatch,
                resume=args.resume,
                async_checkpoint=args.async_checkpoint,
                signature_extra=signature_extra_from_args(args),
                early_stop=args.early_stop,
                eval_variables_fn=_ema_eval_fn(args),
                on_fold_end=on_fold_end,
            )
    except PreemptedError as e:
        # the last completed epoch is on disk; the same command continues
        print(f"Preempted: {e}")
    finally:
        if writer:
            writer.close()


if __name__ == "__main__":
    main()
