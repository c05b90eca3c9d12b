"""Training CLI, family 3, on PyTorch — the flags of
``heuristique_style_transfer_code_tpu/cli/train_multi_patchgan.py`` (the
reference's ``train_best_Multi_PatchGAN.py``) plus ``--device`` (default
``cuda``; ``cpu`` when asked).

The class count comes from ``--data``/train's folders (printed, and written
into the config). K-fold cross-validation with the reference's split seed
42: per fold a fresh train-variant multi-scale PatchGAN (``--model_path``
loaded shape by shape), SGD with momentum 0.9 at the config's ``lr``, the
masked cross-entropy, evaluation, and the reference's artifacts in
``--save_dir``: ``model_fold_<k>.npz`` after every fold,
``retrained_performance.json`` (the folds' results),
``retrained_hyperparameters.json`` (the config), and the k-fold set
(``fold_<k>_performance.json``, ``best_model_fold_<k>.npz``,
``best_global_model.npz``, each npz with its ``_hyperparameters.json``,
``best_model_results.json``, ``training_info.json``, ``events.jsonl``), in
the JAX package's layout. Under norm "instance" every norm of the
discriminators is ``instance_norm_fwd`` on the card and its gradient
``instance_norm_bwd``.

``--resume`` (with SIGTERM preemption, exit 0 and the resume hint),
``--async_checkpoint``, ``--lr_schedule``, ``--warmup_steps``,
``--min_lr_ratio``, ``--clip_grad_norm``, ``--label_smoothing``,
``--early_stop``, ``--tensorboard``, ``--precision float32|bf16``,
``--remat``, ``--grad_accum``, ``--steps_per_dispatch``, ``--profile_dir``,
``--debug_nans``, ``--ema_decay`` (every fold artifact from the weights'
EMA), ``--mixup``/``--cutmix`` (``train/mixing.py``) and ``--auto_batch``
with ``--hbm_budget_gb`` (``train/autotune.py``: on the CPU an estimate)
run;
the flags of ``cli/_common.TRAIN_NOT_PORTED`` and ``--devices`` other than
1 raise "not ported yet". Each fold's fresh weights come from
``torch.Generator().manual_seed(seed + fold)``, not from ``jax.random``.

    python -m heuristique_style_transfer_code_tpu_torch.cli.train_multi_patchgan \\
        --data datasets/weather --config_path cfg.json --epochs 1 \\
        --save_dir out [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from ._common import add_device_args, add_train_args

# the reference's split seed for this family (train_best_Multi_PatchGAN.py:63)
KFOLD_RANDOM_STATE = 42


def build_parser():
    parser = argparse.ArgumentParser(description="Train multi-scale PatchGAN classifier (PyTorch)")
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--epochs", default=25, type=int)
    parser.add_argument("--save_dir", default="Model_Multi_scale_PatchGAN/best", type=str)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--k_folds", default=2, type=int)
    parser.add_argument("--model_path", type=str,
                        help="Weights (.npz or .pth); shape-filtered partial load")
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Train steps launched back to back per host read of their "
                        "losses: the same batches, draws, losses and weights as 1")
    add_device_args(parser)
    add_train_args(parser)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    from ._common import check_train_ported

    check_train_ported(args)

    import torch

    from ..config.schema import MultiPatchGANConfig
    from ..core.device import resolve_device
    from ..data.imagefolder import ImageFolderIndex
    from ..train.factories import setup_multi_patchgan
    from ..train.kfold import run_kfold
    from ..train.preemption import PreemptedError
    from ._common import (
        _ema_eval_fn,
        apply_auto_batch,
        apply_grad_accum,
        load_checkpoint_tree,
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
    cfg = MultiPatchGANConfig.from_json(args.config_path)
    hyperparameters = cfg.to_dict()
    seed = resolve_seed(hyperparameters, args.seed)
    save_fn = make_save_fn(args.checkpoint_format)

    dataset = ImageFolderIndex(os.path.join(args.data, "train"))
    # the class count comes from the dataset, and overrides the config's
    # before the retrained-hyperparameters dump (the reference's :54-59)
    num_classes = len(dataset.classes)
    print(f"Nombre de classes détecté : {num_classes}")
    cfg.num_classes = num_classes
    hyperparameters["num_classes"] = num_classes
    writer = make_writer(args.tensorboard, args.save_dir)

    pretrained = None
    if args.model_path:
        pretrained = load_checkpoint_tree(args.model_path, "multi_patchgan", hyperparameters)
        print(f"Poids du modèle chargés depuis {args.model_path} (shape-filtered)")

    lr_schedule, clip_norm = resolve_lr_schedule(args, cfg, len(dataset.samples), args.k_folds)
    setup = setup_multi_patchgan(
        cfg, num_classes, [(None, None)], pretrained=pretrained,
        compute_dtype=resolve_compute_dtype(args.precision), lr_schedule=lr_schedule,
        clip_norm=clip_norm, label_smoothing=args.label_smoothing, ema_decay=args.ema_decay,
        mix_fn=resolve_mix_fn(args), remat=args.remat, device=device)
    apply_auto_batch(args, setup, cfg, hyperparameters, device)
    apply_grad_accum(args, setup, cfg.batch_size)

    def init_fn(fold):
        model, opt_state = setup.init(torch.Generator().manual_seed(seed + fold))
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
                save_fn=save_fn,
                writer=writer,
                steps_per_dispatch=args.steps_per_dispatch,
                resume=args.resume,
                async_checkpoint=args.async_checkpoint,
                signature_extra=signature_extra_from_args(args),
                early_stop=args.early_stop,
                eval_variables_fn=_ema_eval_fn(args),
                kfold_random_state=KFOLD_RANDOM_STATE,
                save_every_fold=True,
                performance_filename="retrained_performance.json",
            )
    except PreemptedError as e:
        # the last completed epoch is on disk; the same command continues
        print(f"Preempted: {e}")
        return
    finally:
        if writer:
            writer.close()
    cfg.save(os.path.join(args.save_dir, "retrained_hyperparameters.json"))


if __name__ == "__main__":
    main()
