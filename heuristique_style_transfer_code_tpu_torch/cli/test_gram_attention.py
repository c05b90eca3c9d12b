"""Evaluation CLI, family 2, on PyTorch — the flags of
``heuristique_style_transfer_code_tpu/cli/test_gram_attention.py`` plus
``--device`` (default ``cuda``; the counterpart of ``JAX_PLATFORMS``).

Ported: ``--mode classification`` (``classification_results.json``),
``--mode style_transfer`` (``style_transfer_<date>/<label>/*.png``; with
``--style_image`` the content+style loop, ``content_style_<i>.png``, and
``--style_weight``, ``--content_weight``, ``--tv_weight``,
``--style_layers`` and ``--style_init``),
``--mode tsne`` (``tsne_visualization.png``), ``--mode tsne_interactive``
(the Tk GUI, or the static plot without ``DISPLAY``) and ``--mode camera``
(a camera or a video file, ``--classes`` required), with ``--precision
float32|bf16``. The flags listed in ``_NOT_PORTED`` raise a "not ported
yet" error.
``--model_path`` takes the JAX package's ``.npz`` or a reference ``.pth``
(``checkpoint/pth_converter.py``).

    python -m heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention \\
        --data DATA --config_path cfg.json --model_path model.npz \\
        --mode classification --save_dir out [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Iterable, Optional

import numpy as np
import torch

from ..checkpoint.convert import load_jax_tree
from ..config.schema import GramAttentionConfig
from ..core.device import resolve_device
from ..data.imagefolder import ImageFolderIndex
from ..data.loader import HostLoader
from ..models.gram_attention import GramAttention, gram_attention_apply, gram_attention_init
from ._common import (
    cast_forward,
    check_ported,
    count_params,
    load_checkpoint_tree,
    maybe_subset,
    resolve_compute_dtype,
    weighted_auc_or_none,
)

MODES = ["tsne", "tsne_interactive", "classification", "camera", "style_transfer"]
PORTED_MODES = ("classification", "style_transfer", "tsne", "tsne_interactive", "camera")

# flag -> its default; any other value raises "not ported yet"
_NOT_PORTED = {
    "remat": False,
    "shard_spatial": 1,
    "devices": None,
    "steps_per_dispatch": 1,
    "profile_dir": None,
    "debug_nans": False,
}


def build_parser():
    parser = argparse.ArgumentParser(description="Gram+attention weather classifier (PyTorch)")
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--mode", type=str, choices=MODES, default="classification")
    parser.add_argument("--save_dir", type=str, required=True)
    parser.add_argument("--colors", nargs="+")
    parser.add_argument("--classes", nargs="+")
    parser.add_argument("--save_camera_video", action="store_true")
    parser.add_argument("--prob_threshold", default=0.5, type=float)
    parser.add_argument("--measure_time", action="store_true")
    parser.add_argument("--layers", type=int, default=4,
                        help="Encoder child truncation for style transfer")
    parser.add_argument("--threshold", default=1e-7, type=float)
    parser.add_argument("--learning_rate", default=0.01, type=float)
    parser.add_argument("--num_iterations", default=500, type=int)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="Override the config batch size")
    parser.add_argument("--shard_spatial", type=int, default=1, help="Not ported yet")
    parser.add_argument("--style_image", type=str, default=None,
                        help="Classic content+style transfer: re-render every test image in "
                        "this image's style (style Gram + content feature loss) instead of "
                        "the reference's texture-from-self loop")
    parser.add_argument("--style_weight", type=float, default=1.0)
    parser.add_argument("--content_weight", type=float, default=1.0)
    parser.add_argument("--tv_weight", type=float, default=0.0,
                        help="Total-variation smoothness term on the canvas "
                        "(--style_image runs only)")
    parser.add_argument("--style_layers", choices=["last", "all"], default="last",
                        help="--style_image runs: match style Grams at the truncation point "
                        "only, or at every executed ResNet stage (same encoder pass)")
    parser.add_argument("--remat", action="store_true", help="Not ported yet")
    parser.add_argument("--style_init", choices=["content", "noise"], default="content",
                        help="Pixel initialisation for --style_image runs: the content image "
                        "or normal noise like the texture loop")
    parser.add_argument("--quantized_path", type=str, default=None)
    parser.add_argument("--afficher_params", action="store_true")
    parser.add_argument("--compute_auc", action="store_true",
                        help="Calculer le score AUC pour le modèle")
    parser.add_argument("--camera_index", type=str, default="0")
    parser.add_argument("--device_preprocess", action="store_true")
    parser.add_argument("--precision", choices=["float32", "bf16", "int8"], default="float32",
                        help="float32 or bf16 (int8 is not ported yet)")
    parser.add_argument("--devices", type=int, default=None, help="Not ported yet")
    parser.add_argument("--profile_dir", type=str, default=None, help="Not ported yet")
    parser.add_argument("--debug_nans", action="store_true", help="Not ported yet")
    parser.add_argument("--steps_per_dispatch", type=int, default=1, help="Not ported yet")
    parser.add_argument("--calib_data", type=str, default=None)
    parser.add_argument("--qat_steps", type=int, default=0)
    parser.add_argument("--qat_lr", type=float, default=1e-4)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu; there is no silent fallback")
    return parser


def _check_ported(args) -> None:
    if args.mode not in PORTED_MODES:
        raise NotImplementedError(f"--mode {args.mode} is not ported yet ({', '.join(PORTED_MODES)})")
    check_ported(args, _NOT_PORTED)
    resolve_compute_dtype(args.precision)


def load_gram_attention(model_path: str, truncate: int, num_classes: Optional[int], s: int,
                        device: torch.device, tree=None) -> GramAttention:
    """Checkpoint (``.npz`` or a reference ``.pth``), or its ``tree`` ->
    family-2 model on ``device`` (the weight bridge fails on any leaf
    missing or left over). ``num_classes=None`` reads the class count from
    the checkpoint's classifier."""
    if tree is None:
        tree = load_checkpoint_tree(model_path, "gram_attention", {})
    if "encoder" not in tree and isinstance(tree.get("moco"), dict):
        raise NotImplementedError(
            "a family-1 checkpoint in the family-2 CLI (encoder reuse with a "
            "fresh head) is not ported yet"
        )
    if "encoder" not in tree:
        raise KeyError(
            f"Checkpoint {model_path} has no encoder for the gram-attention "
            "architecture (expected 'encoder' or a family-1 'moco' tree)."
        )
    if num_classes is None:
        num_classes = int(np.shape(tree["classifier"]["kernel"])[-1])
    model = gram_attention_init(None, truncate, num_classes, s, device=device)
    return load_jax_tree(model, tree)


def run_classification(
    model: GramAttention,
    loader: Iterable[dict],
    save_dir: str,
    *,
    truncate: int,
    gram_matrix_size: int,
    num_classes: int,
    compute_dtype: Optional[torch.dtype] = None,
    compute_auc: bool = False,
) -> dict:
    """``--mode classification`` over any iterable of ``HostLoader``
    batches: weighted precision/recall/F1 (and AUC) of the valid entries,
    written to ``save_dir/classification_results.json``."""
    from ..data.augment import eval_preprocess
    from ..metrics.classification import weighted_precision_recall_f1

    device = next(model.parameters()).device
    preds, labels, probs = [], [], []
    with torch.inference_mode():
        for batch in loader:
            images = eval_preprocess(torch.from_numpy(np.asarray(batch["image"])).to(device))
            if compute_dtype is not None:
                images = images.to(compute_dtype)
            _, logits = gram_attention_apply(model, images, truncate, gram_matrix_size,
                                             num_classes)
            pr = torch.softmax(logits.float(), dim=-1).cpu().numpy()
            p = torch.argmax(logits, dim=-1).cpu().numpy()
            n = batch["n_valid"]
            preds.extend(p[:n].tolist())
            labels.extend(np.asarray(batch["label"])[:n].tolist())
            probs.append(pr[:n])

    results = weighted_precision_recall_f1(labels, preds)
    if compute_auc:
        results["auc"] = weighted_auc_or_none(labels, np.concatenate(probs))
    os.makedirs(save_dir, exist_ok=True)
    results_path = os.path.join(save_dir, "classification_results.json")
    with open(results_path, "w") as f:
        json.dump(results, f, indent=4)
    print(f"Classification results saved to {results_path}")
    return results


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_ported(args)
    device = resolve_device(args.device)
    os.makedirs(args.save_dir, exist_ok=True)

    cfg = GramAttentionConfig.from_json(args.config_path)
    idx = ImageFolderIndex(os.path.join(args.data, "test"))
    num_classes = len(idx.classes)
    truncate = cfg.truncate_layer
    s = cfg.gram_matrix_size

    tree = load_checkpoint_tree(args.model_path, "gram_attention", cfg.to_dict())
    if args.afficher_params:
        total = count_params(tree)
        print(f"Nombre total de paramètres du modèle (TruncatedResNet50_for_test) : {total}")
    model = load_gram_attention(args.model_path, truncate, num_classes, s, device, tree=tree)
    del tree

    samples = maybe_subset(idx.samples, args.num_samples, cfg.seed)
    loader = HostLoader(samples, args.batch_size or cfg.batch_size)
    dtype = resolve_compute_dtype(args.precision)

    def apply_eval(m, images):
        return gram_attention_apply(m, images, truncate, s, num_classes)

    if args.mode == "classification":
        run_classification(model, loader, args.save_dir, truncate=truncate,
                           gram_matrix_size=s, num_classes=num_classes,
                           compute_dtype=dtype, compute_auc=args.compute_auc)
    elif args.mode in ("tsne", "tsne_interactive"):
        from ..tasks.embeddings import compute_embeddings_with_paths

        emb, labels, img_paths = compute_embeddings_with_paths(
            cast_forward(lambda m, images: apply_eval(m, images)[0], dtype), model, loader,
            samples)
        if args.mode == "tsne":
            from ..tasks.tsne import perform_tsne

            # the family-2 artifact name (test_RESNET50_Truncate_gram_attention.py:110)
            perform_tsne(emb, labels, idx.classes, args.colors, args.save_dir,
                         filename="tsne_visualization.png")
        else:
            from ..tasks.tsne import plot_tsne_interactive

            plot_tsne_interactive(emb, labels, idx.classes, img_paths, args.colors,
                                  save_dir=args.save_dir)
    elif args.mode == "camera":
        from ..tasks.camera import run_camera

        # the reference's camera mode needs --classes, with no config or data fallback
        if args.classes is None:
            raise ValueError(
                "You must specify classes with the --classes option for camera mode."
            )
        cam_index = int(args.camera_index) if args.camera_index.isdigit() else args.camera_index
        run_camera(
            cast_forward(lambda m, images: apply_eval(m, images)[1], dtype), model,
            args.classes, save_video=args.save_camera_video, save_dir=args.save_dir,
            prob_threshold=args.prob_threshold, measure_time=args.measure_time,
            camera_index=cam_index, host_downscale=not args.device_preprocess,
        )
    elif args.style_image:
        from ..data.loader import load_image_staged
        from ..tasks.style_transfer import content_style_transfer_gram_attention

        content_style_transfer_gram_attention(
            model, loader, load_image_staged(args.style_image), args.save_dir,
            layers=args.layers, truncate_layer=truncate, style_weight=args.style_weight,
            content_weight=args.content_weight, tv_weight=args.tv_weight,
            style_layers=args.style_layers, threshold=args.threshold,
            num_iterations=args.num_iterations, learning_rate=args.learning_rate,
            init=args.style_init, compute_dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed or 0),
        )
    else:
        from ..tasks.style_transfer import style_transfer_gram_attention

        style_transfer_gram_attention(
            model, loader, args.save_dir,
            layers=args.layers, threshold=args.threshold,
            num_iterations=args.num_iterations, learning_rate=args.learning_rate,
            truncate_layer=truncate, compute_dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed or 0),
        )


if __name__ == "__main__":
    main()
