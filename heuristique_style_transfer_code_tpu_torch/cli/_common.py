"""Shared CLI plumbing (the parts of ``cli/_common.py`` of the JAX package
that the evaluation CLIs of families 1, 2 and 3, ``serve_style`` and the
train CLIs of families 1, 2 and 3 need)."""
from __future__ import annotations

import os
import random
from typing import Any, List, Optional

import numpy as np
import torch


def resolve_class_names(
    args_classes: Optional[List[str]],
    config: dict,
    data_root: Optional[str],
    split: str = "test",
) -> List[str]:
    """--classes > config["classes"] > the dataset's class directories >
    the reference's four weather classes."""
    if args_classes:
        return list(args_classes)
    if "classes" in config:
        return list(config["classes"])
    if data_root:
        from ..data.imagefolder import ImageFolderIndex

        return ImageFolderIndex(os.path.join(data_root, split)).classes
    return ["fog", "rain", "snow", "sun"]


def maybe_subset(samples, num_samples: Optional[int], seed: Optional[int] = None):
    """--num_samples random subsetting, the same draw as the JAX CLI's."""
    if num_samples is None or num_samples >= len(samples):
        return samples
    rng = random.Random(seed)
    indices = list(range(len(samples)))
    rng.shuffle(indices)
    return [samples[i] for i in indices[:num_samples]]


def load_checkpoint_tree(model_path: str, family: str, config: dict) -> Any:
    """A checkpoint -> JAX-layout tree of numpy arrays: a reference ``.pth``
    (or ``.pt``) through the converter for ``family`` (truncated_resnet50,
    gram_attention, multi_patchgan, multi_patchgan_test; the PatchGAN ones
    read patch_sizes, ndf and norm from ``config``), a flat-key ``.npz``
    through the npz reader. An orbax directory raises: not ported yet."""
    if model_path.endswith((".pth", ".pt")):
        from ..checkpoint import pth_converter as pc

        if family == "truncated_resnet50":
            return pc.convert_moco_checkpoint(model_path)
        if family == "gram_attention":
            return pc.convert_gram_attention_checkpoint(model_path)
        if family in ("multi_patchgan", "multi_patchgan_test"):
            convert = (pc.convert_multi_patchgan_checkpoint if family == "multi_patchgan"
                       else pc.convert_multi_patchgan_test_checkpoint)
            return convert(model_path, config.get("patch_sizes", {}), ndf=config.get("ndf", 64),
                           norm=config.get("norm", "batch"))
        raise ValueError(family)
    if os.path.isdir(model_path):
        raise NotImplementedError(f"{model_path}: orbax checkpoints are not ported yet "
                                  "(.npz and .pth only)")
    from ..checkpoint.io import load_pytree_npz

    return load_pytree_npz(model_path)


def load_truncated_resnet50(model_path: str, truncate: int, device: torch.device,
                            tree: Any = None):
    """Checkpoint (or its ``tree``) -> the family-1 model on ``device``;
    ``dim`` and the class count come from the checkpoint's fc kernels. The
    weight bridge fails on any leaf missing or left over."""
    from ..checkpoint.convert import load_jax_tree
    from ..models.truncated_resnet50 import truncated_resnet50_init

    if tree is None:
        tree = load_checkpoint_tree(model_path, "truncated_resnet50", {})
    if "moco" not in tree or "classifier" not in tree:
        raise KeyError(
            f"Checkpoint {model_path} does not contain the family-1 "
            "{'moco', 'classifier'} tree."
        )
    dim = int(np.shape(tree["moco"]["fc"]["kernel"])[-1])
    num_classes = int(np.shape(tree["classifier"]["fc"]["kernel"])[-1])
    model = truncated_resnet50_init(None, truncate, num_classes, dim, device=device)
    return load_jax_tree(model, tree)


def load_multi_patchgan(model_path: str, cfg, device: torch.device, tree: Any = None):
    """Checkpoint (or its ``tree``) of family 3 -> the test-variant model on
    ``device``, built from ``cfg`` (a ``MultiPatchGANConfig``). A
    train-variant tree is loaded as the JAX CLI loads it
    (``cli/test_multi_patchgan.py:89-111`` there, the reference's partial
    load): the test architecture initialised from a generator seeded with
    ``cfg.seed or 0``, then every same-path, same-shape leaf of the
    checkpoint through ``shape_filtered_update``, with a "N/M tensors
    matched" line."""
    from ..checkpoint.convert import load_jax_tree, to_jax_tree
    from ..models.multi_patchgan import SCALES, multiscale_test_init

    if tree is None:
        tree = load_checkpoint_tree(model_path, "multi_patchgan_test", cfg.to_dict())
    train_variant = not all(isinstance(tree.get(s), dict) and "features" in tree[s]
                            for s in SCALES)
    generator = torch.Generator().manual_seed(cfg.seed or 0) if train_variant else None
    model = multiscale_test_init(generator, cfg.patch_sizes, ndf=cfg.ndf,
                                 num_classes=cfg.num_classes,
                                 gram_matrix_dim=cfg.gram_matrix_dim, norm=cfg.norm,
                                 device=device)
    if train_variant:
        from ..checkpoint.pth_converter import shape_filtered_update

        stats: dict = {}
        tree = shape_filtered_update(to_jax_tree(model), tree, stats)
        print(
            "Train-variant checkpoint detected: shape-filtered partial load "
            f"into the test architecture ({stats.get('loaded', 0)}/"
            f"{stats.get('total', 0)} tensors matched)."
        )
    return load_jax_tree(model, tree)


def count_params(tree: Any) -> int:
    if isinstance(tree, dict):
        return sum(count_params(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_params(v) for v in tree)
    return int(np.prod(tree.shape)) if hasattr(tree, "shape") else 0


def make_writer(enabled: bool, save_dir: str, sub: str = "tensorboard"):
    """``--tensorboard``: a ``SummaryWriter`` logging to ``save_dir/sub``,
    or None when not asked for; where TensorBoard cannot be imported, the
    JAX CLI's message and None (the run goes on without the log)."""
    if not enabled:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(log_dir=os.path.join(save_dir, sub))
    except ImportError:
        print("TensorBoard unavailable; continuing without it.")
        return None


def resolve_compute_dtype(precision: Optional[str]) -> Optional[torch.dtype]:
    """--precision -> compute dtype (None = float32 passthrough)."""
    if precision in (None, "float32"):
        return None
    if precision == "bf16":
        return torch.bfloat16
    raise NotImplementedError(f"--precision {precision} is not ported yet (float32, bf16)")


def cast_forward(forward, compute_dtype: Optional[torch.dtype]):
    """``forward(model, images)`` with the images cast to
    ``compute_dtype`` (parameters stay f32 and are cast at each op)."""
    if compute_dtype is None:
        return forward

    def wrapped(model, images):
        return forward(model, images.to(compute_dtype))

    return wrapped


def weighted_auc_or_none(labels, probs, branch_on: str = "labels"):
    """Reference ``--compute_auc``: weighted one-vs-rest AUC for the
    multiclass case, ``probs[:, 1]`` for the binary one; None (with the
    reference's warning) when it cannot be computed. Imports scikit-learn.

    The references test "multiclass" differently: the gram-attention one
    on the labels, ``len(np.unique(labels)) > 2`` (``branch_on="labels"``),
    the Multi-PatchGAN one on the probability matrix, ``probs.shape[1] > 2``
    (``branch_on="probs"``). They part where a model of more than two
    classes is evaluated on labels that cover two or fewer: the labels
    branch takes the binary AUC of ``probs[:, 1]``, the probs branch stays
    multiclass, which raises for the absent classes and gives None."""
    from sklearn.metrics import roc_auc_score

    labels = np.asarray(labels)
    probs = np.asarray(probs)
    multiclass = probs.shape[1] > 2 if branch_on == "probs" else len(np.unique(labels)) > 2
    try:
        if multiclass:
            return float(roc_auc_score(labels, probs, multi_class="ovr", average="weighted"))
        return float(roc_auc_score(labels, probs[:, 1]))
    except ValueError as e:
        print(f"[WARNING] Impossible de calculer l'AUC : {e}")
        return None


def add_device_args(parser, precisions=("float32", "bf16")) -> None:
    """The JAX CLIs' ``add_tpu_args`` flags (``--devices``, ``--profile_dir``
    and ``--debug_nans`` parse but are not ported yet) plus ``--device``."""
    parser.add_argument("--precision", choices=list(precisions), default="float32",
                        help="Compute precision policy")
    parser.add_argument("--devices", type=int, default=None, help="Not ported yet")
    parser.add_argument("--profile_dir", type=str, default=None, help="Not ported yet")
    parser.add_argument("--debug_nans", action="store_true", help="Not ported yet")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent fallback")


def check_ported(args, not_ported: dict) -> None:
    """Raise "not ported yet" for any flag of ``not_ported`` ({flag: its
    default}) given another value."""
    for flag, default in not_ported.items():
        if getattr(args, flag) != default:
            raise NotImplementedError(f"--{flag} is not ported yet")


def add_train_args(parser) -> None:
    """The JAX train CLIs' ``add_train_tpu_args`` flags. The ones in
    ``TRAIN_NOT_PORTED`` parse but raise "not ported yet" at any other
    value than their default (``check_ported``)."""
    parser.add_argument("--checkpoint_format", choices=["npz", "orbax"], default="npz",
                        help="Checkpoint backend for saved models (orbax: not ported yet)")
    parser.add_argument("--resume", action="store_true",
                        help="Continue an interrupted run from its last completed epoch "
                        "(bit-identical on the CPU; uses the in-progress checkpoint the "
                        "trainer writes every epoch in --save_dir); also arms SIGTERM "
                        "preemption")
    parser.add_argument("--grad_accum", type=int, default=1, help="Not ported yet")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="With --resume: write the per-epoch in-progress checkpoint in "
                        "a background thread (a host copy at submit; the same atomic file)")
    parser.add_argument("--zero1", action="store_true", help="Not ported yet")
    parser.add_argument("--remat", action="store_true", help="Not ported yet")
    parser.add_argument("--parallel_folds", action="store_true", help="Not ported yet")
    parser.add_argument("--auto_batch", action="store_true", help="Not ported yet")
    parser.add_argument("--hbm_budget_gb", type=float, default=None, help="Not ported yet")
    parser.add_argument("--lr_schedule", choices=["constant", "cosine", "linear"],
                        default="constant",
                        help="Learning-rate schedule over each fold's steps (default: the "
                        "reference's fixed rate), evaluated at the update count")
    parser.add_argument("--warmup_steps", type=int, default=0,
                        help="Linear LR warmup steps (0 -> config lr) before the schedule")
    parser.add_argument("--min_lr_ratio", type=float, default=0.0,
                        help="Schedule floor as a fraction of the config lr")
    parser.add_argument("--clip_grad_norm", type=float, default=None,
                        help="Clip gradients to this global norm (trainable leaves only) "
                        "before the optimiser update")
    parser.add_argument("--label_smoothing", type=float, default=0.0, metavar="EPS",
                        help="Label smoothing for the training cross-entropy "
                        "(F.cross_entropy semantics; validation losses stay unsmoothed)")
    parser.add_argument("--mixup", type=float, default=None, metavar="ALPHA",
                        help="Not ported yet")
    parser.add_argument("--cutmix", type=float, default=None, metavar="ALPHA",
                        help="Not ported yet")
    parser.add_argument("--ema_decay", type=float, default=None, metavar="DECAY",
                        help="Not ported yet")
    parser.add_argument("--early_stop", type=int, default=None, metavar="PATIENCE",
                        help="Validate after every epoch and stop a fold after PATIENCE "
                        "consecutive epochs without a new best validation loss; fold "
                        "artifacts then describe the best epoch's weights")


# the train flags this port does not run yet -> their defaults
TRAIN_NOT_PORTED = {
    "grad_accum": 1,
    "zero1": False,
    "remat": False,
    "parallel_folds": False,
    "auto_batch": False,
    "hbm_budget_gb": None,
    "mixup": None,
    "cutmix": None,
    "ema_decay": None,
    "steps_per_dispatch": 1,
    "checkpoint_format": "npz",
    "profile_dir": None,
    "debug_nans": False,
}


def check_train_ported(args) -> None:
    """``check_ported`` over ``TRAIN_NOT_PORTED``, and ``--devices`` other
    than 1 (data-parallel training)."""
    check_ported(args, TRAIN_NOT_PORTED)
    if args.devices not in (None, 1):
        raise NotImplementedError("--devices (data-parallel training) is not ported yet; "
                                  "pass --devices 1 or leave it out")


def resolve_seed(config: dict, cli_seed: Optional[int]) -> int:
    """config > CLI > random, the choice written back into ``config`` (the
    JAX ``resolve_seed``); seeds Python's, numpy's and torch's generators."""
    seed = config.get("seed", cli_seed)
    if seed is None:
        seed = random.randint(0, 1_000_000)
        config["seed"] = seed
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def select_augmentations(args):
    """The reference's transform selection (JAX ``:929-951``):
    (geometric names, colour names), each list ``[None]`` when not asked
    for. ``--num_*_transforms`` picks with Python's ``random.sample``,
    which ``resolve_seed`` seeded as the JAX CLI's ``seed_everything``
    does, so one seed picks the same transforms in both packages."""
    from ..data.augment import AVAILABLE_COLOR_TRANSFORMS, AVAILABLE_GEOM_TRANSFORMS

    color = [None]
    geom = [None]
    if getattr(args, "color_aug", False) and getattr(args, "num_color_transforms", 0) > 0:
        n = min(args.num_color_transforms, len(AVAILABLE_COLOR_TRANSFORMS))
        color = random.sample(list(AVAILABLE_COLOR_TRANSFORMS), n)
    if getattr(args, "geom_aug", False):
        if getattr(args, "geom_transforms", None):
            geom = []
            for t in args.geom_transforms:
                if t in AVAILABLE_GEOM_TRANSFORMS:
                    geom.append(t)
                else:
                    print(f"Warning: Geometric transform '{t}' is not recognized.")
            geom = geom or [None]
        elif getattr(args, "num_geom_transforms", 0) > 0:
            n = min(args.num_geom_transforms, len(AVAILABLE_GEOM_TRANSFORMS))
            geom = random.sample(list(AVAILABLE_GEOM_TRANSFORMS), n)
    return geom, color


def resolve_lr_schedule(args, cfg, n_samples: int, k_folds: int):
    """(schedule or None, clip norm or None) from the flags; the horizon is
    each fold's optimiser steps (``train/schedules.steps_per_fold``), and
    the count restarts with each fold's optimiser."""
    name = args.lr_schedule or "constant"
    warmup = int(args.warmup_steps or 0)
    clip = args.clip_grad_norm
    if name == "constant" and warmup == 0:
        return None, clip
    from ..train.schedules import make_lr_schedule, steps_per_fold

    total = steps_per_fold(n_samples, k_folds, cfg.batch_size, args.epochs)
    sched = make_lr_schedule(name, cfg.lr, total, warmup, args.min_lr_ratio)
    if sched is not None:
        print(f"lr schedule: {name}, warmup {warmup} steps, horizon {total} "
              f"steps/fold, floor {cfg.lr * args.min_lr_ratio:g}")
    return sched, clip


def signature_extra_from_args(args) -> Optional[dict]:
    """The step configuration that changes a run's numbers and lives
    outside the model's hyperparameters, for the resume signature (the JAX
    ``signature_extra_from_args``, over the flags the port runs; the ones it
    refuses never get here). Each entry is left out at its default. Unlike
    the JAX one, it holds ``--freeze_layers``: a resume that freezes
    another set of parameters is refused."""
    extra = {}
    for flag, default in (
        ("precision", "float32"), ("color_aug", False), ("geom_aug", False),
        ("num_color_transforms", 0), ("num_geom_transforms", 0), ("geom_transforms", None),
        ("lr_schedule", "constant"), ("warmup_steps", 0),
        ("min_lr_ratio", 0.0), ("clip_grad_norm", None), ("label_smoothing", 0.0),
        ("early_stop", None), ("freeze_encoder", False), ("freeze_layers", False),
    ):
        val = getattr(args, flag, default)
        if val != default and val is not None:
            extra[flag] = val
    return extra or None


def make_save_fn(checkpoint_format: str):
    """The checkpoint writer for ``run_kfold``: npz (the
    ``<name>.npz`` + ``<name>_hyperparameters.json`` pair); orbax raises
    "not ported yet"."""
    if checkpoint_format != "npz":
        raise NotImplementedError(f"--checkpoint_format {checkpoint_format} is not ported yet")
    from ..checkpoint.io import save_model_and_hyperparameters

    return save_model_and_hyperparameters
