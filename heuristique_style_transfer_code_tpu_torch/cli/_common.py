"""Shared CLI plumbing (the parts of ``cli/_common.py`` of the JAX package
that the evaluation CLIs of families 1, 2 and 3 and ``serve_style``
need)."""
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
