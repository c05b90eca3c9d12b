"""Train a feed-forward style network (fast neural style) on PyTorch — the
flags of ``heuristique_style_transfer_code_tpu/cli/train_style_net.py``
plus ``--device`` (default ``cuda``; ``cpu`` when asked).

One ``--style_image`` trains the classic single-style net; repeated
``--style_image NAME=PATH`` flags train one conditional net for the whole
gallery (per-style instance-norm affines, shared convs). The frozen loss
network is the family-2 encoder of ``--config_path`` and ``--model_path``
(an ``.npz`` or a reference ``.pth``). The run writes ``style_net.npz``
in the JAX layout and ``style_net_hyperparameters.json`` with the JAX
CLI's keys, which ``serve_style --net`` of either package serves.
``--resume``, ``--checkpoint_every``, ``--async_checkpoint``, SIGTERM
preemption, ``--lr_schedule``, ``--warmup_steps``, ``--min_lr_ratio``,
``--clip_grad_norm``, ``--style_sampling``, ``--stylize_dir`` and
``--precision float32|bf16`` run; ``--devices`` other than 1,
``--profile_dir`` and ``--debug_nans`` raise "not ported yet".

The net's random init comes from ``torch.Generator().manual_seed(seed)``,
not from ``jax.random``: the two packages start from different weights.

    python -m heuristique_style_transfer_code_tpu_torch.cli.train_style_net \\
        --data datasets/weather --style_image vangogh=vangogh.jpg \\
        --style_image monet=monet.jpg --config_path cfg.json \\
        --model_path models/best_global_model.npz --epochs 2 --batch_size 16 \\
        --save_dir style_net_out [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from ._common import add_device_args, check_ported

# flag -> its default; any other value raises "not ported yet"
_NOT_PORTED = {"profile_dir": None, "debug_nans": False}


def build_parser():
    parser = argparse.ArgumentParser(
        description="Train a feed-forward (one-pass) style-transfer network (PyTorch)")
    parser.add_argument("--data", type=str, required=True,
                        help="Content images: an ImageFolder root (its train/ split is used "
                        "when present)")
    parser.add_argument("--style_image", action="append", required=True, metavar="NAME=PATH",
                        help="Style image (a bare PATH names the style after the file stem). "
                        "Repeat the flag to train one conditional net for a whole gallery")
    parser.add_argument("--config_path", type=str, required=True,
                        help="Family-2 (gram_attention) encoder config")
    parser.add_argument("--model_path", type=str, required=True,
                        help="Family-2 encoder checkpoint (the frozen loss network)")
    parser.add_argument("--layers", type=int, default=None,
                        help="Encoder truncation, the reference's Sequential slice")
    parser.add_argument("--style_layers", choices=["last", "all"], default="all",
                        help="Style Grams at the truncation point only, or at every executed "
                        "ResNet stage")
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--width", type=int, default=32,
                        help="Transformer-net base channel width")
    parser.add_argument("--n_res", type=int, default=5, help="Residual blocks at the bottleneck")
    parser.add_argument("--style_weight", type=float, default=1.0)
    parser.add_argument("--content_weight", type=float, default=1.0)
    parser.add_argument("--tv_weight", type=float, default=0.0)
    parser.add_argument("--crop", type=int, default=224, help="Training crop (multiple of 4)")
    parser.add_argument("--save_dir", type=str, default="style_net_out")
    parser.add_argument("--num_samples", type=int, default=None,
                        help="Subsample the content set (smoke tests)")
    parser.add_argument("--log_every", type=int, default=50)
    parser.add_argument("--stylize_dir", type=str, default=None,
                        help="After training, stylise one content batch and write "
                        "[original | stylised] PNGs here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--afficher_params", action="store_true")
    parser.add_argument("--resume", action="store_true",
                        help="Continue an interrupted fit from its in-progress checkpoint in "
                        "--save_dir; also arms SIGTERM preemption (the position is "
                        "checkpointed and the process exits 0 with this hint)")
    parser.add_argument("--checkpoint_every", type=int, default=200, metavar="STEPS",
                        help="With --resume: in-progress checkpoint cadence in optimiser steps "
                        "(epoch ends always checkpoint; 0 = epoch ends only)")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="With --resume: write in-progress checkpoints in a background "
                        "thread (a host copy at submit; the same atomic file)")
    parser.add_argument("--lr_schedule", choices=["constant", "cosine", "linear"],
                        default="constant",
                        help="LR schedule over the whole fit (horizon = steps/epoch x "
                        "--epochs), evaluated at the optimiser's update count, which rides "
                        "the resume checkpoint")
    parser.add_argument("--warmup_steps", type=int, default=0,
                        help="Linear LR warmup steps (0 -> --lr) before the schedule")
    parser.add_argument("--min_lr_ratio", type=float, default=0.0,
                        help="Schedule floor as a fraction of --lr")
    parser.add_argument("--clip_grad_norm", type=float, default=None,
                        help="Clip gradients to this global norm before the Adam update")
    parser.add_argument("--style_sampling", choices=["balanced", "uniform"], default="balanced",
                        help="Multi-style galleries only: per-batch style draw, 'balanced' "
                        "(the gallery as evenly as possible every batch) or 'uniform'")
    add_device_args(parser)
    return parser


def _content_samples(root: str):
    from ..data.imagefolder import ImageFolderIndex

    train_dir = os.path.join(root, "train")
    chosen = train_dir if os.path.isdir(train_dir) else root
    return ImageFolderIndex(chosen).samples


def _check_ported(args) -> None:
    check_ported(args, _NOT_PORTED)
    if args.devices not in (None, 1):
        raise NotImplementedError("--devices (data-parallel training) is not ported yet; "
                                  "pass --devices 1 or leave it out")


def _stylize_samples(args, net, loader, style_names, dtype) -> None:
    """``--stylize_dir``: one content batch through the trained net, the
    first 8 images as [original | stylised] PNGs (one set per style of a
    gallery)."""
    import numpy as np

    from ..core.geometry import center_crop_offsets
    from ..tasks.fast_style import make_stylize_fn
    from ..tasks.style_transfer import _save_side_by_side

    batch = next(iter(loader))["image"]
    c = args.crop
    top, left = center_crop_offsets(batch.shape[1], batch.shape[2], c)
    if len(style_names) > 1:
        variants = []
        for s, name in enumerate(style_names):
            onehot = np.zeros((len(style_names),), np.float32)
            onehot[s] = 1.0
            variants.append((f"_{name}", onehot))
    else:
        variants = [("", None)]
    for suffix, weights in variants:
        stylize = make_stylize_fn(net, crop=c, compute_dtype=dtype, style_weights=weights)
        out = stylize(batch).cpu().numpy()
        for i in range(min(8, out.shape[0])):
            orig = batch[i][top:top + c, left:left + c]
            _save_side_by_side(orig.astype(np.float32) / 255.0,
                               out[i].astype(np.float32) / 255.0,
                               os.path.join(args.stylize_dir, f"stylise{suffix}_{i}.png"))
    print(f"Exemples stylisés écrits dans {args.stylize_dir}")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_ported(args)
    if args.crop % 4:
        raise SystemExit("--crop must be a multiple of 4 (two 2x down/up stages)")

    import torch

    from ..checkpoint.convert import to_jax_tree
    from ..checkpoint.io import save_model_and_hyperparameters
    from ..config.schema import GramAttentionConfig
    from ..core.device import resolve_device
    from ..data.loader import HostLoader, load_image_staged
    from ..nn.transformer_net import count_params, transformer_net_init
    from ..tasks.fast_style import (
        clear_net_inprogress,
        style_net_signature,
        train_fast_style,
        train_multi_style,
    )
    from ..tasks.style_transfer import make_extract_fn_gram_attention
    from ..train.preemption import PreemptedError
    from ._common import load_checkpoint_tree, maybe_subset, resolve_compute_dtype
    from .test_gram_attention import load_gram_attention

    device = resolve_device(args.device)
    dtype = resolve_compute_dtype(args.precision)

    styles = {}
    for spec in args.style_image:
        name, sep, path = spec.partition("=")
        if not sep:
            name, path = os.path.splitext(os.path.basename(spec))[0], spec
        if name in styles:
            raise SystemExit(f"duplicate style name {name!r}")
        styles[name] = path
    style_names = list(styles)
    multi = len(style_names) > 1

    cfg = GramAttentionConfig.from_json(args.config_path)
    tree = load_checkpoint_tree(args.model_path, "gram_attention", cfg.to_dict())
    encoder = load_gram_attention(args.model_path, cfg.truncate_layer, None,
                                  cfg.gram_matrix_size, device, tree=tree)
    extract_fn = make_extract_fn_gram_attention(encoder, cfg.truncate_layer, layers=args.layers,
                                                compute_dtype=dtype,
                                                style_layers=args.style_layers)

    net = transformer_net_init(torch.Generator().manual_seed(args.seed), width=args.width,
                               n_res=args.n_res, n_styles=len(style_names) if multi else None,
                               device=device)
    if args.afficher_params:
        print(f"Nombre total de paramètres du modèle : {count_params(net)}")

    samples = maybe_subset(_content_samples(args.data), args.num_samples, seed=args.seed)
    loader = HostLoader(samples, args.batch_size, shuffle=True, seed=args.seed)
    styles_u8 = [load_image_staged(p) for p in styles.values()]

    # the schedule's horizon is the whole fit; the plain float stays
    # the rate when no schedule is asked for
    learning_rate = args.lr
    if args.lr_schedule != "constant" or args.warmup_steps:
        from ..train.schedules import make_lr_schedule

        total = max(1, len(loader) * args.epochs)
        sched = make_lr_schedule(args.lr_schedule, args.lr, total, args.warmup_steps,
                                 args.min_lr_ratio)
        if sched is not None:
            learning_rate = sched
            print(f"lr schedule: {args.lr_schedule}, warmup {args.warmup_steps} steps, "
                  f"horizon {total} steps, floor {args.lr * args.min_lr_ratio:g}")

    hyper = {
        "family": "style_net",
        "width": args.width,
        "n_res": args.n_res,
        "crop": args.crop,
        "style_image": os.path.basename(next(iter(styles.values()))),
        "style_names": style_names,
        "style_images": [os.path.basename(p) for p in styles.values()],
        "style_layers": args.style_layers,
        "style_weight": args.style_weight,
        "content_weight": args.content_weight,
        "tv_weight": args.tv_weight,
        "lr": args.lr,
        "epochs": args.epochs,
        "batch_size": args.batch_size,
        "encoder_config": cfg.to_dict(),
    }
    # the run's identity for --resume: everything that changes the trajectory
    signature = style_net_signature({
        **hyper,
        "seed": args.seed,
        "num_samples": args.num_samples,
        "lr_schedule": args.lr_schedule,
        "warmup_steps": args.warmup_steps,
        "min_lr_ratio": args.min_lr_ratio,
        "clip_grad_norm": args.clip_grad_norm,
        "precision": args.precision,
        "layers": args.layers,
        "model_path": os.path.abspath(args.model_path),
        "devices": args.devices,
        "style_sampling": args.style_sampling if multi else None,
    })

    knobs = dict(
        epochs=args.epochs,
        style_weight=args.style_weight,
        content_weight=args.content_weight,
        tv_weight=args.tv_weight,
        learning_rate=learning_rate,
        crop=args.crop,
        compute_dtype=dtype,
        log_every=args.log_every,
        clip_norm=args.clip_grad_norm,
        save_dir=args.save_dir,
        resume=args.resume,
        checkpoint_every=args.checkpoint_every,
        async_checkpoint=args.async_checkpoint,
        signature=signature,
    )
    if args.resume:
        os.makedirs(args.save_dir, exist_ok=True)
    try:
        if multi:
            net, history = train_multi_style(net, extract_fn, loader, styles_u8, seed=args.seed,
                                             style_sampling=args.style_sampling, **knobs)
        else:
            net, history = train_fast_style(net, extract_fn, loader, styles_u8[0], **knobs)
    except PreemptedError as e:
        # the position is on disk; the same command with --resume continues
        print(f"Preempted: {e}")
        return

    hyper["final_loss"] = history[-1] if history else None
    save_model_and_hyperparameters(to_jax_tree(net), hyper, args.save_dir, "style_net")
    if args.resume:
        clear_net_inprogress(args.save_dir)  # the finished fit supersedes it
    gallery = f" (galerie {style_names})" if multi else ""
    print(f"Réseau de style sauvegardé dans {args.save_dir}/style_net.npz "
          f"(loss finale {hyper['final_loss']}){gallery}")

    if args.stylize_dir:
        _stylize_samples(args, net, loader, style_names, dtype)


if __name__ == "__main__":
    main()
