"""Training CLI, family 1, on PyTorch — the flags of
``heuristique_style_transfer_code_tpu/cli/train_truncated_resnet50.py``
(the reference's ``train_best_RESNET50_Truncate.py``) plus ``--device``
(default ``cuda``; ``cpu`` when asked).

K-fold cross-validation over ``--data``/train: per fold a fresh truncated
ResNet50 MoCo encoder and classifier (``--model_path``: the encoder always
loads, the classifier when its shape fits the dataset's classes, with the
reference's message each fold), SGD with momentum 0.9 at the config's
``lr``, the masked cross-entropy, evaluation, and the reference's
artifacts in ``--save_dir``: ``fold_<k>_performance.json``,
``best_model_fold_<k>.npz``, ``best_global_model.npz`` (each with its
``_hyperparameters.json``), ``best_model_results.json``,
``training_info.json`` and ``events.jsonl``. The npz files are the JAX
package's layout, which the ``test_truncated_resnet50`` CLI of either
package reads.

``--geom_aug``/``--color_aug`` with ``--num_geom_transforms``,
``--num_color_transforms`` or ``--geom_transforms`` pick transforms as the
reference does (``_common.select_augmentations``); each train sample then
appears once per (geometric, colour) combination, augmented on the device
with parameters drawn on the host (``data/augment.py``). ``--freeze_encoder``
trains the classifier alone (the encoder's batch-norm statistics still
move). ``--resume`` (with SIGTERM preemption, exit 0 and the resume hint),
``--async_checkpoint``, ``--lr_schedule``, ``--warmup_steps``,
``--min_lr_ratio``, ``--clip_grad_norm``, ``--label_smoothing``,
``--early_stop``, ``--tensorboard``, ``--precision float32|bf16``,
``--remat``, ``--grad_accum``, ``--steps_per_dispatch``, ``--profile_dir``,
``--debug_nans``, ``--ema_decay`` (every fold artifact from the weights'
EMA), ``--mixup``/``--cutmix`` (``train/mixing.py``), ``--auto_batch``
with ``--hbm_budget_gb`` (``train/autotune.py``: on the CPU an estimate)
and ``--parallel_folds`` (every fold as one vmapped program,
``parallel/foldparallel.py``) run;
``--devices N`` (data-parallel training over N ranks, one process a
device: NCCL between cards, gloo on the CPU; ``cli/_common.build_mesh``;
with ``--parallel_folds`` the folds over a (fold, data) mesh of ranks)
and ``--zero1`` run; ``--checkpoint_format orbax`` raises "not ported
yet".

Each fold's fresh weights come from ``torch.Generator().manual_seed(seed +
fold)``, and the augmentation's draws from a ``torch.Generator`` as well,
not from ``jax.random``: the two packages start a fold from different
weights and augment with different numbers.

    python -m heuristique_style_transfer_code_tpu_torch.cli.train_truncated_resnet50 \\
        --data datasets/weather --config_path cfg.json --k_folds 2 --epochs 1 \\
        --save_dir out [--geom_aug --num_geom_transforms 2] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from ._common import add_device_args, add_train_args


def build_parser():
    parser = argparse.ArgumentParser(
        description="Fine-tuning truncated ResNet50 for weather classification (PyTorch)")
    parser.add_argument("--data", type=str, required=True, help="Path to dataset root directory")
    parser.add_argument("--model_path", type=str, help="Path to pre-trained weights (.npz or .pth)")
    parser.add_argument("--config_path", type=str, required=True, help="Hyperparameter JSON")
    parser.add_argument("--epochs", default=25, type=int)
    parser.add_argument("--save_dir", default="saved_models", type=str)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--k_folds", default=5, type=int)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--color_aug", action="store_true")
    parser.add_argument("--geom_aug", action="store_true")
    parser.add_argument("--num_color_transforms", type=int, default=0)
    parser.add_argument("--num_geom_transforms", type=int, default=0)
    parser.add_argument("--geom_transforms", nargs="+", type=str, default=None)
    parser.add_argument("--freeze_encoder", action="store_true",
                        help="Freeze all encoder layers and train only the classifier")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Train steps launched back to back per host read of their "
                        "losses: the same batches, draws, losses and weights as 1")
    add_device_args(parser)
    add_train_args(parser)
    return parser


def fold_load_message(tree, dim: int, num_classes: int):
    """(the tree each fold starts from, the reference's per-fold message)
    for a checkpoint's tree, or None (JAX CLI ``:89-115``): the encoder
    always; the classifier where its fc kernel is (dim, num_classes)."""
    if tree is None:
        return None, "pas de checkpoint fourni, entraînement from scratch."
    fc = tree.get("classifier", {}).get("fc") if isinstance(tree, dict) else None
    if isinstance(fc, dict) and "kernel" in fc and "bias" in fc:
        got = tuple(int(s) for s in fc["kernel"].shape)  # (in, out)
        if got == (dim, num_classes):
            return tree, "Classifier chargé depuis le checkpoint."
        # the reference prints torch-layout (out, in) shapes
        return {"moco": tree["moco"]}, (
            f"mismatch classifier → checkpoint a {tuple(reversed(got))}, "
            f"attendu {(num_classes, dim)}. Nouveau classifieur non chargé.")
    return {"moco": tree["moco"]}, (
        "pas de poids de classifieur dans le checkpoint → nouveau classifieur.")


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ._common import check_train_ported

    check_train_ported(args)

    import torch

    from ..config.schema import TruncatedResNetConfig
    from ..core.device import resolve_device
    from ..data.augment import generate_transform_combinations
    from ..data.imagefolder import ImageFolderIndex
    from ..train.factories import setup_truncated_resnet50
    from ..train.kfold import run_kfold
    from ..train.preemption import PreemptedError
    from ._common import (
        _ema_eval_fn,
        apply_auto_batch,
        apply_grad_accum,
        build_mesh,
        load_checkpoint_tree,
        make_save_fn,
        make_writer,
        resolve_compute_dtype,
        resolve_lr_schedule,
        resolve_fold_parallel,
        resolve_mix_fn,
        resolve_seed,
        runtime_flags,
        select_augmentations,
        signature_extra_from_args,
    )

    device = resolve_device(args.device)
    cfg = TruncatedResNetConfig.from_json(args.config_path)
    mesh, launched = build_mesh(args, cfg.batch_size, __spec__.name, argv)
    if launched:
        return
    if mesh is not None:
        device = mesh.device
    main_rank = mesh is None or mesh.is_main
    os.makedirs(args.save_dir, exist_ok=True)
    hyperparameters = cfg.to_dict()
    seed = resolve_seed(hyperparameters, args.seed, mesh)
    cfg.seed = seed
    save_fn = make_save_fn(args.checkpoint_format)

    geom, color = select_augmentations(args)
    combos = generate_transform_combinations(geom, color)

    dataset = ImageFolderIndex(os.path.join(args.data, "train"))
    num_classes = len(dataset.classes)
    writer = make_writer(args.tensorboard and main_rank, args.save_dir)

    tree = (load_checkpoint_tree(args.model_path, "truncated_resnet50", hyperparameters)
            if args.model_path else None)
    pretrained, fold_load_msg = fold_load_message(tree, cfg.dim, num_classes)

    lr_schedule, clip_norm = resolve_lr_schedule(args, cfg, len(dataset.samples), args.k_folds)
    setup = setup_truncated_resnet50(
        cfg, num_classes, combos, pretrained=pretrained, freeze_encoder=args.freeze_encoder,
        compute_dtype=resolve_compute_dtype(args.precision), lr_schedule=lr_schedule,
        clip_norm=clip_norm, label_smoothing=args.label_smoothing, ema_decay=args.ema_decay,
        mix_fn=resolve_mix_fn(args), remat=args.remat, device=device, mesh=mesh,
        zero1=args.zero1)
    apply_auto_batch(args, setup, cfg, hyperparameters, device, mesh)
    apply_grad_accum(args, setup, cfg.batch_size)
    foldwise_step, fold_mesh = resolve_fold_parallel(args, setup, args.k_folds, mesh,
                                                     cfg.batch_size)

    def init_fn(fold):
        model, opt_state = setup.init(torch.Generator().manual_seed(seed + fold))
        print(f"Fold {fold}: {fold_load_msg}")
        if args.freeze_encoder:
            print(f"Fold {fold}: encodeur gelé (seul le classifieur sera entraîné).")
        return model, opt_state, setup.train_step, setup.eval_step

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
                combos_per_sample=len(combos),
                save_fn=save_fn,
                writer=writer,
                steps_per_dispatch=args.steps_per_dispatch,
                foldwise_step=foldwise_step,
                resume=args.resume,
                async_checkpoint=args.async_checkpoint,
                signature_extra=signature_extra_from_args(args),
                early_stop=args.early_stop,
                eval_variables_fn=_ema_eval_fn(args),
                mesh=mesh,
                fold_mesh=fold_mesh,
                grad_accum=args.grad_accum,
            )
    except PreemptedError as e:
        # the last completed epoch is on disk; the same command continues
        print(f"Preempted: {e}")
    finally:
        if writer:
            writer.close()


if __name__ == "__main__":
    main()
