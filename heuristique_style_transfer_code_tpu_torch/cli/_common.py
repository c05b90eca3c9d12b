"""Shared CLI plumbing (the parts of ``cli/_common.py`` of the JAX package
that the evaluation CLIs of families 1, 2 and 3, ``serve_style`` and the
train CLIs of families 1, 2 and 3 need): the train flags, ``--auto_batch``,
the mixing and EMA hooks, and the int8 builders of the family-1 and
family-2 evaluation CLIs."""
from __future__ import annotations

import contextlib
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
    """--precision -> compute dtype (None = float32 passthrough). "int8"
    gives None, as in JAX: the quantised path handles its dtypes itself."""
    if precision in (None, "float32", "int8"):
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
    """The JAX CLIs' ``add_tpu_args`` flags (``--devices`` parses but is
    not ported yet) plus ``--device``."""
    parser.add_argument("--precision", choices=list(precisions), default="float32",
                        help="Compute precision policy")
    parser.add_argument("--devices", type=int, default=None, help="Not ported yet")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of the run to this directory")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Raise FloatingPointError at the first NaN of a forward or a "
                        "backward (module outputs, losses, autograd's anomaly mode)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent fallback")


@contextlib.contextmanager
def runtime_flags(args):
    """A CLI's run under ``--debug_nans`` (``utils/debug.debug_nans``) and
    ``--profile_dir`` (``utils/logging.maybe_profile``)."""
    from ..utils.debug import debug_nans
    from ..utils.logging import maybe_profile

    with debug_nans(args.debug_nans), maybe_profile(args.profile_dir):
        yield


def close_on_stop(service, stack: contextlib.ExitStack) -> None:
    """Close ``stack`` when ``service.stop`` returns: a recycling worker's
    builder returns its service before the serving that its
    ``runtime_flags`` scope must cover (the trace is written at the
    close)."""
    stop = service.stop

    def stop_then_close(drain: bool = True):
        try:
            stop(drain=drain)
        finally:
            stack.close()

    service.stop = stop_then_close


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
                        help="Checkpoint backend for saved models (orbax: not ported yet, "
                        "since orbax.checkpoint imports jax)")
    parser.add_argument("--resume", action="store_true",
                        help="Continue an interrupted run from its last completed epoch "
                        "(bit-identical on the CPU; uses the in-progress checkpoint the "
                        "trainer writes every epoch in --save_dir); also arms SIGTERM "
                        "preemption")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Gradient accumulation: run the configured batch as this many "
                        "sequential micro-batches with one optimiser update; the loss and "
                        "gradients are the full batch's masked mean, batch norms use "
                        "micro-batch statistics (ghost BN). batch_size must divide; "
                        "exclusive with --steps_per_dispatch>1")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="With --resume: write the per-epoch in-progress checkpoint in "
                        "a background thread (a host copy at submit; the same atomic file)")
    parser.add_argument("--zero1", action="store_true", help="Not ported yet")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute block-internal activations in the backward "
                        "(torch.utils.checkpoint per bottleneck / per discriminator unit): the "
                        "same gradients and running statistics, less activation memory, "
                        "about a third more forward work")
    parser.add_argument("--parallel_folds", action="store_true", help="Not ported yet")
    parser.add_argument("--auto_batch", action="store_true",
                        help="Probe doubling batch sizes and adopt the largest whose train "
                        "step fits the memory budget: on the card one real step each, read "
                        "from the allocator's peak (an out-of-memory probe is a miss); on "
                        "the CPU an estimate (parameters, gradients, optimiser state, staged "
                        "batch and the tensors autograd saves). Exclusive with "
                        "--grad_accum>1 and --lr_schedule/--warmup_steps")
    parser.add_argument("--hbm_budget_gb", type=float, default=None,
                        help="Memory budget for --auto_batch in GiB (default: the card's "
                        "total memory; required on the CPU)")
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
                        help="Mixup with lambda ~ Beta(ALPHA, ALPHA): the augmented batch "
                        "is blended with a rolled copy of itself and the train loss is "
                        "lam*CE(y) + (1-lam)*CE(y_partner) (timm batch mode; train loss "
                        "only)")
    parser.add_argument("--cutmix", type=float, default=None, metavar="ALPHA",
                        help="CutMix: a box of area share 1-lambda from a rolled copy of "
                        "the batch, lambda corrected to the clipped box's pixel share; with "
                        "--mixup too, a fair coin a batch picks one")
    parser.add_argument("--ema_decay", type=float, default=None, metavar="DECAY",
                        help="Keep an exponential moving average of the weights (decay per "
                        "optimiser step, e.g. 0.999) in the optimiser state and evaluate "
                        "and save every fold artifact from it (batch-norm statistics stay "
                        "live); training itself is unchanged")
    parser.add_argument("--early_stop", type=int, default=None, metavar="PATIENCE",
                        help="Validate after every epoch and stop a fold after PATIENCE "
                        "consecutive epochs without a new best validation loss; fold "
                        "artifacts then describe the best epoch's weights")


# the train flags this port does not run yet -> their defaults: ZeRO-1 and
# fold-parallel training need several cards; orbax checkpoints need
# orbax.checkpoint, which imports jax
TRAIN_NOT_PORTED = {
    "zero1": False,
    "parallel_folds": False,
    "checkpoint_format": "npz",
}


def check_train_ported(args) -> None:
    """``check_ported`` over ``TRAIN_NOT_PORTED``, and ``--devices`` other
    than 1 (data-parallel training)."""
    check_ported(args, TRAIN_NOT_PORTED)
    if args.devices not in (None, 1):
        raise NotImplementedError("--devices (data-parallel training) is not ported yet; "
                                  "pass --devices 1 or leave it out")


def apply_grad_accum(args, setup, batch_size: int) -> None:
    """``--grad_accum K`` (the JAX ``apply_grad_accum``): the setup's train
    step becomes the accumulation step (``FamilySetup.accum_step``), after
    the JAX CLI's checks and with its messages."""
    n = int(getattr(args, "grad_accum", 1) or 1)
    if n <= 1:
        return
    if getattr(args, "steps_per_dispatch", 1) > 1:
        raise SystemExit("--grad_accum and --steps_per_dispatch>1 are "
                         "exclusive (pick one batching of the dispatch)")
    if batch_size % n:
        raise SystemExit(f"--grad_accum {n} does not divide batch_size {batch_size}")
    setup.train_step = setup.accum_step(n)
    print(f"Gradient accumulation: {n} micro-batches of {batch_size // n} per optimiser step")


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
    if getattr(args, "auto_batch", False):
        raise SystemExit(
            "--lr_schedule/--warmup_steps are exclusive with --auto_batch: "
            "the schedule horizon is fixed per batch size before the probe "
            "runs; pick the batch first (run --auto_batch alone), then "
            "schedule at that batch"
        )
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
    refuses never get here). Each entry is left out at its default: a
    resume under another ``--ema_decay`` (the optimiser state's structure),
    ``--mixup`` or ``--cutmix`` (the trajectory) is refused, as in JAX.
    Unlike the JAX one, it holds ``--freeze_layers``: a resume that freezes
    another set of parameters is refused."""
    extra = {}
    n = int(getattr(args, "grad_accum", 1) or 1)
    if n > 1:  # ghost-BN micro-batch statistics change the trajectory
        extra["grad_accum"] = n
    for flag, default in (
        ("precision", "float32"), ("color_aug", False), ("geom_aug", False),
        ("num_color_transforms", 0), ("num_geom_transforms", 0), ("geom_transforms", None),
        ("lr_schedule", "constant"), ("warmup_steps", 0),
        ("min_lr_ratio", 0.0), ("clip_grad_norm", None), ("label_smoothing", 0.0),
        ("early_stop", None), ("ema_decay", None), ("freeze_encoder", False),
        ("freeze_layers", False), ("mixup", None), ("cutmix", None),
    ):
        val = getattr(args, flag, default)
        if val != default and val is not None:
            extra[flag] = val
    return extra or None


def make_save_fn(checkpoint_format: str):
    """The checkpoint writer for ``run_kfold``: npz (the
    ``<name>.npz`` + ``<name>_hyperparameters.json`` pair). orbax raises
    "not ported yet": ``orbax.checkpoint`` imports jax, which the port
    never does, and the card's machine lacks ``tensorstore``, its storage
    layer, which would serve without jax (``chip_smoke.py`` prints
    whether it is there)."""
    if checkpoint_format != "npz":
        raise NotImplementedError(f"--checkpoint_format {checkpoint_format} is not ported yet")
    from ..checkpoint.io import save_model_and_hyperparameters

    return save_model_and_hyperparameters


def resolve_mix_fn(args):
    """``train/mixing.make_mix_fn`` from ``--mixup``/``--cutmix``; None
    when both are off (the step is then the unmixed one)."""
    mixup = getattr(args, "mixup", None)
    cutmix = getattr(args, "cutmix", None)
    if mixup is None and cutmix is None:
        return None
    from ..train.mixing import make_mix_fn

    return make_mix_fn(mixup_alpha=mixup, cutmix_alpha=cutmix)


def _ema_eval_fn(args):
    """``run_kfold(eval_variables_fn=)`` for ``--ema_decay``: every fold
    artifact is evaluated and saved from the EMA weights the optimiser
    state carries; None when the flag is off."""
    if getattr(args, "ema_decay", None) is None:
        return None
    from ..train.optim import extract_ema_variables

    return extract_ema_variables


def apply_auto_batch(args, setup, cfg, hyperparameters=None, device="cuda") -> None:
    """``--auto_batch`` (the JAX ``apply_auto_batch``): probe the doubling
    ladder from ``cfg.batch_size`` with ``train/autotune`` on ``device``
    and adopt the largest batch that fits the budget. Mutates
    ``cfg.batch_size`` and ``hyperparameters`` (the saved
    ``_hyperparameters.json`` files and the resume signature); call it
    before anything reads them."""
    if not getattr(args, "auto_batch", False):
        return
    if getattr(args, "grad_accum", 1) > 1 or getattr(args, "parallel_folds", False):
        raise SystemExit(
            "--auto_batch is exclusive with --grad_accum>1 and "
            "--parallel_folds (those dispatch different step programs than "
            "the one the probe measures)"
        )
    from ..data.loader import STAGING_SIZE
    from ..train.autotune import (
        GIB,
        autotune_batch,
        batch_candidates,
        describe_report,
        device_hbm_bytes,
        train_step_peak_bytes,
    )

    budget = (int(args.hbm_budget_gb * GIB) if args.hbm_budget_gb
              else device_hbm_bytes(device))
    if budget is None:
        raise SystemExit(
            "--auto_batch: this backend does not report a memory budget; "
            "pass --hbm_budget_gb"
        )
    cands = batch_candidates(cfg.batch_size)
    chosen, report = autotune_batch(
        lambda b: train_step_peak_bytes(setup, b, STAGING_SIZE, device), budget, cands)
    print(describe_report(report, budget))
    if chosen is None:
        raise SystemExit(
            f"--auto_batch: even batch {cands[0]} exceeds the budget; try "
            "--remat and/or --grad_accum"
        )
    if chosen != cfg.batch_size:
        print(f"--auto_batch: adopting batch {chosen} (configured {cfg.batch_size})")
        cfg.batch_size = chosen
        if hyperparameters is not None:
            hyperparameters["batch_size"] = chosen
    else:
        print(f"--auto_batch: keeping configured batch {cfg.batch_size}")


# ------------------------------------------------------------------ int8


def add_calib_data_arg(parser) -> None:
    """``--calib_data``, ``--qat_steps`` and ``--qat_lr`` of the int8
    evaluation CLIs (JAX ``:358-378``)."""
    parser.add_argument(
        "--calib_data", type=str, default=None,
        help="ImageFolder root for int8 activation calibration (its train/ split when "
        "present, else test/). Default: the --data root's train/ split; the evaluated "
        "test split only as a last resort, with a printed warning")
    parser.add_argument(
        "--qat_steps", type=int, default=0,
        help="With --precision int8: quantization-aware fine-tune for N SGD steps through "
        "the fake-quant forward (nn/resnet_qat.py) on the calibration split before export. "
        "0 (default) = plain PTQ. Ignored when --quantized_path already exists")
    parser.add_argument("--qat_lr", type=float, default=1e-4,
                        help="Learning rate for the --qat_steps fine-tune (SGD momentum 0.9)")


def make_calibration_loader(args, batch_size: int):
    """The int8 calibration source (JAX ``make_calibration_loader``):
    ``--calib_data`` when given, else ``--data``; within it the ``train/``
    split, else ``test/`` (with JAX's warning when that is the evaluated
    split). Classes are interleaved round-robin, since only the first
    batches calibrate."""
    root = getattr(args, "calib_data", None) or getattr(args, "data", None)
    if not root:
        raise ValueError(
            "--precision int8 nécessite --calib_data (ou --data) pour la "
            "calibration"
        )
    train_dir = os.path.join(root, "train")
    test_dir = os.path.join(root, "test")
    if os.path.isdir(train_dir):
        chosen = train_dir
    elif os.path.isdir(test_dir):
        chosen = test_dir
        if not getattr(args, "calib_data", None):
            print(
                "Avertissement: calibration int8 sur le split de test évalué "
                "(aucun split train/ sous --data) — les métriques int8 "
                "peuvent être légèrement optimistes; fournissez --calib_data."
            )
    else:
        raise ValueError(
            f"Aucun split train/ ou test/ trouvé sous {root} pour la "
            "calibration int8"
        )
    from ..data.imagefolder import ImageFolderIndex
    from ..data.loader import HostLoader

    idx = ImageFolderIndex(chosen)
    by_class: dict = {}
    for s in idx.samples:
        by_class.setdefault(s[1], []).append(s)
    groups = [by_class[k] for k in sorted(by_class)]
    samples = []
    for i in range(max(len(g) for g in groups)):
        for g in groups:
            if i < len(g):
                samples.append(g[i])
    return HostLoader(samples, min(batch_size, 32), shuffle=False)


def collect_calibration_batches(loader, n: int = 2, with_labels: bool = False,
                                device="cuda"):
    """The first ``n`` batches through the evaluation preprocess on
    ``device``: the tensors the quantised encoder will take.
    ``with_labels``: (images, labels) pairs for the QAT fine-tune (pad
    entries keep label -1, which the loss masks)."""
    from ..data.augment import eval_preprocess

    cal = []
    for bi, b in enumerate(loader):
        images = eval_preprocess(torch.as_tensor(b["image"]).to(device))
        if with_labels:
            cal.append((images, torch.as_tensor(np.asarray(b["label"])).to(device)))
        else:
            cal.append(images)
        if bi >= n - 1:
            break
    return cal


def calibration_inputs(args, batch_size: int, device):
    """(calibration batches, labelled batches or None) of the int8 CLIs:
    the first 2 batches of ``make_calibration_loader``, or with
    ``--qat_steps`` 4 labelled ones for the fine-tune, whose first 2
    calibrate (JAX's CLIs); (None, None) when ``--quantized_path`` exists
    (nothing to calibrate)."""
    if args.quantized_path and os.path.exists(args.quantized_path):
        return None, None
    loader = make_calibration_loader(args, batch_size)
    if args.qat_steps:
        labeled = collect_calibration_batches(loader, n=4, with_labels=True, device=device)
        return [images for images, _ in labeled[:2]], labeled
    return collect_calibration_batches(loader, device=device), None


def _quantized_encoder(model, encoder, truncate: int, cal_batches, quantized_path,
                       qat_steps: int, qat_lr: float, labeled_batches, qat_logits):
    """``encoder`` (a part of ``model``) quantised: loaded from
    ``quantized_path`` when it exists, else calibrated on ``cal_batches``,
    with ``qat_steps`` > 0 the whole ``model`` fine-tuned first through
    ``qat_logits(model, scales, images)`` on ``labeled_batches``, then
    quantised and, with a path, saved."""
    from ..nn.resnet_int8 import (
        calibrate_activation_scales,
        load_quantized,
        quantize_resnet50,
        save_quantized,
    )

    device = next(encoder.parameters()).device
    if quantized_path and os.path.exists(quantized_path):
        return load_quantized(quantized_path, device=device)
    if cal_batches is None:
        raise ValueError("int8 needs calibration batches (or an existing quantized_path)")
    scales = calibrate_activation_scales(encoder, cal_batches, truncate)
    if qat_steps:
        if not labeled_batches:
            raise ValueError("--qat_steps needs labeled calibration batches")
        from ..train.qat import qat_finetune

        qat_finetune(model, lambda m, x: qat_logits(m, scales, x), labeled_batches, qat_steps,
                     qat_lr)
    q = quantize_resnet50(encoder, scales, truncate, device=device)
    if quantized_path:
        save_quantized(q, quantized_path)
        print(f"Quantised encoder saved to {quantized_path}")
    return q


def build_int8_family1(model, truncate: int, cal_batches=None, keep_encoder: bool = False,
                       quantized_path: Optional[str] = None, qat_steps: int = 0,
                       qat_lr: float = 1e-4, labeled_batches=None):
    """The family-1 int8 setup (JAX ``build_int8_family1``): the encoder
    post-training quantised (or loaded from ``quantized_path``), the MoCo
    fc and the classifier kept in float. ``qat_steps`` > 0 first
    fine-tunes encoder and heads through the fake-quant forward on
    ``labeled_batches``. The float encoder is dropped from ``model`` unless
    ``keep_encoder`` (Grad-CAM needs it). Returns (forward_eval, embed_fn,
    model) with ``forward_eval(model, images) -> logits`` and
    ``embed_fn(model, images) -> embeddings``."""
    from ..models.truncated_resnet50 import combined_apply_int8, combined_apply_qat
    from ..nn.resnet_int8 import resnet50_apply_int8
    from ..ops.pooling import global_avg_pool

    q = _quantized_encoder(
        model, model.moco.encoder, truncate, cal_batches, quantized_path, qat_steps, qat_lr,
        labeled_batches,
        lambda m, scales, x: combined_apply_qat(m.moco, m.classifier, scales, x, truncate))
    if not keep_encoder:
        model.moco.encoder = None

    def forward_eval(m, images):
        return combined_apply_int8(q, m.moco, m.classifier, images.float())

    def embed_fn(m, images):
        return m.moco.fc(global_avg_pool(resnet50_apply_int8(q, images.float())))

    return forward_eval, embed_fn, model


def build_int8_family2(model, truncate: int, gram_matrix_size: int, num_classes: int,
                       cal_batches=None, quantized_path: Optional[str] = None,
                       qat_steps: int = 0, qat_lr: float = 1e-4, labeled_batches=None):
    """The family-2 int8 setup (JAX ``build_int8_family2``): the encoder
    post-training quantised at ``min(truncate, 8)`` (or loaded), the
    pooled Grams (``pooled_gram_fwd`` on the card) of the dequantised
    stage maps, attention and classifier in float. ``qat_steps`` > 0
    fine-tunes the whole model through the fake-quant forward first. The
    float encoder is dropped. Returns (apply_eval, model) with
    ``apply_eval(model, images) -> (embeddings, logits)``."""
    from ..models.gram_attention import gram_attention_apply_int8, gram_attention_apply_qat

    s = gram_matrix_size

    q = _quantized_encoder(
        model, model.encoder, min(truncate, 8), cal_batches, quantized_path, qat_steps, qat_lr,
        labeled_batches,
        lambda m, scales, x: gram_attention_apply_qat(m, scales, x, truncate, s, num_classes)[1])
    model.encoder = None

    def apply_eval(m, images):
        return gram_attention_apply_int8(q, m, images.float(), s, num_classes)

    return apply_eval, model
