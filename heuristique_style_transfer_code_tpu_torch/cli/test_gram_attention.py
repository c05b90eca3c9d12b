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
float32|bf16``, ``--remat`` (style transfer), ``--steps_per_dispatch``
(classification and the t-SNE modes), ``--profile_dir`` and
``--debug_nans``, and ``--precision int8`` in the classification and
t-SNE modes (the JAX CLI's): the encoder post-training quantised
(``nn/resnet_int8.py``; the pooled Grams of its dequantised stage maps
still through ``pooled_gram_fwd``), calibrated on ``--calib_data``
(default the ``--data`` train/ split), loaded from ``--quantized_path``
when that file exists and written there when it does not, with
``--qat_steps``/``--qat_lr`` a quantization-aware fine-tune first.
``--devices N`` (classification, the t-SNE modes and style transfer, as
JAX passes them a mesh; camera ignores it) runs N ranks, one process a
device (NCCL between cards, gloo with ``--device cpu``), each decoding and
running its rows of every batch; rank 0 writes the files of ``--devices
1``. ``--shard_spatial S`` (style transfer) cuts each canvas's rows over
S ranks as well (``cli/_common.resolve_style_mesh``: data x spatial ranks,
``parallel/spatial.py``). The flags listed in ``_NOT_PORTED`` raise a "not
ported yet" error.
``--model_path`` takes the JAX package's ``.npz``, a reference ``.pth``
(``checkpoint/pth_converter.py``) or a family-1 checkpoint, whose encoder
is reused under a fresh gram/attention head.

    python -m heuristique_style_transfer_code_tpu_torch.cli.test_gram_attention \\
        --data DATA --config_path cfg.json --model_path model.npz \\
        --mode classification --save_dir out [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..checkpoint.convert import load_jax_tree
from ..config.schema import GramAttentionConfig
from ..core.device import resolve_device
from ..data.imagefolder import ImageFolderIndex
from ..models.gram_attention import GramAttention, gram_attention_apply, gram_attention_init
from ._common import (
    DEVICES_HELP,
    add_calib_data_arg,
    agreed_seed,
    cast_forward,
    check_ported,
    count_params,
    eval_loader,
    load_checkpoint_tree,
    maybe_subset,
    resolve_compute_dtype,
    resolve_eval_mesh,
    resolve_style_mesh,
    runtime_flags,
    weighted_auc_or_none,
)

MODES = ["tsne", "tsne_interactive", "classification", "camera", "style_transfer"]
PORTED_MODES = ("classification", "style_transfer", "tsne", "tsne_interactive", "camera")
# the modes to which the JAX CLI passes a mesh: --devices N runs them on N ranks
MESH_MODES = ("classification", "tsne", "tsne_interactive", "style_transfer")

# flag -> its default; any other value raises "not ported yet"
_NOT_PORTED: dict = {}


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
    parser.add_argument("--shard_spatial", type=int, default=1,
                        help="Style transfer: shard each canvas's H rows over this many "
                        "devices (halo exchanges in the encoder's forward and backward; "
                        "combines with --devices, which shards the batch axis)")
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
    parser.add_argument("--remat", action="store_true",
                        help="Style transfer: recompute each bottleneck's activations in the "
                        "backward instead of keeping them (less memory, the same pixels)")
    parser.add_argument("--style_init", choices=["content", "noise"], default="content",
                        help="Pixel initialisation for --style_image runs: the content image "
                        "or normal noise like the texture loop")
    parser.add_argument("--quantized_path", type=str, default=None,
                        help="Persisted quantised-encoder npz (int8, the JAX package's "
                        "layout): loaded if present (no calibration), else written after "
                        "calibration")
    parser.add_argument("--afficher_params", action="store_true")
    parser.add_argument("--compute_auc", action="store_true",
                        help="Calculer le score AUC pour le modèle")
    parser.add_argument("--camera_index", type=str, default="0")
    parser.add_argument("--device_preprocess", action="store_true")
    parser.add_argument("--precision", choices=["float32", "bf16", "int8"], default="float32",
                        help="Compute precision: float32, bf16, or int8 (the post-training "
                        "quantised encoder; classification and t-SNE modes)")
    parser.add_argument("--devices", type=int, default=None, help=DEVICES_HELP)
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of the run to this directory")
    parser.add_argument("--debug_nans", action="store_true",
                        help="Raise FloatingPointError at the first NaN of a forward or a "
                        "backward (module outputs, losses, autograd's anomaly mode)")
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Évaluer K batches par aller-retour device (K batches envoyés "
                        "ensemble, leurs K passes lancées à la suite, une seule lecture — "
                        "résultats identiques). Incompatible avec --measure_time "
                        "(times_test.json est par batch)")
    add_calib_data_arg(parser)
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
    if "encoder" not in tree:
        raise KeyError(
            f"Checkpoint {model_path} has no encoder for the gram-attention "
            "architecture (expected 'encoder' or a family-1 'moco' tree)."
        )
    if num_classes is None:
        num_classes = int(np.shape(tree["classifier"]["kernel"])[-1])
    model = gram_attention_init(None, truncate, num_classes, s, device=device)
    return load_jax_tree(model, tree)


def family1_encoder_tree(tree, truncate: int, num_classes: int, s: int, seed: int):
    """A family-1 ``{moco, classifier}`` tree -> a family-2 tree: its
    encoder, and a fresh gram/attention head drawn from a CPU generator
    seeded with ``seed``, through ``shape_filtered_update`` (JAX
    ``:123-145``, the reference's encoder-only load; JAX draws the head
    from ``jax.random``). Any other tree comes back unchanged."""
    if "encoder" in tree or not isinstance(tree.get("moco"), dict):
        return tree
    from ..checkpoint.convert import to_jax_tree
    from ..checkpoint.pth_converter import shape_filtered_update

    init = gram_attention_init(torch.Generator().manual_seed(seed), truncate, num_classes, s,
                               device="cpu")
    tree = shape_filtered_update(to_jax_tree(init), {"encoder": tree["moco"].get("encoder", {})})
    print("Family-1 checkpoint detected: loaded its encoder; gram/attention "
          "head freshly initialised.")
    return tree


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
    steps_per_dispatch: int = 1,
    apply_fn: Optional[Callable] = None,
    mesh=None,
) -> dict:
    """``--mode classification`` over any iterable of ``HostLoader``
    batches: weighted precision/recall/F1 (and AUC) of the valid entries,
    written to ``save_dir/classification_results.json``. Each batch's
    argmax and probabilities come back in one fetch, or K batches' with
    ``steps_per_dispatch`` K (``core/dispatch.py``), the same values.
    ``apply_fn(model, images) -> (embeddings, logits)`` replaces the float
    forward (the int8 one). On a data-parallel ``mesh`` the loader holds
    this rank's rows, the results are gathered and rank 0 writes."""
    from ..core.dispatch import dispatched_eval_iter
    from ..data.augment import eval_preprocess
    from ..metrics.classification import weighted_precision_recall_f1

    def step(images_u8):
        images = eval_preprocess(images_u8)
        if compute_dtype is not None:
            images = images.to(compute_dtype)
        if apply_fn is not None:
            _, logits = apply_fn(model, images)
        else:
            _, logits = gram_attention_apply(model, images, truncate, gram_matrix_size,
                                             num_classes)
        pr = torch.softmax(logits.float(), dim=-1)
        return torch.cat([torch.argmax(logits, dim=-1, keepdim=True).float(), pr], dim=1)

    device = next(model.parameters()).device
    preds, labels, probs = [], [], []
    with torch.inference_mode():
        for batch, packed in dispatched_eval_iter(step, loader, device,
                                                  steps_per_dispatch=steps_per_dispatch,
                                                  mesh=mesh):
            n = batch["n_valid"]
            preds.extend(packed[:n, 0].astype(np.int64).tolist())
            labels.extend(np.asarray(batch["label"])[:n].tolist())
            probs.append(packed[:n, 1:])

    results = weighted_precision_recall_f1(labels, preds)
    if compute_auc:
        results["auc"] = weighted_auc_or_none(labels, np.concatenate(probs))
    if mesh is not None and not mesh.is_main:
        return results
    os.makedirs(save_dir, exist_ok=True)
    results_path = os.path.join(save_dir, "classification_results.json")
    with open(results_path, "w") as f:
        json.dump(results, f, indent=4)
    print(f"Classification results saved to {results_path}")
    return results


def _int8(args, model, cfg, truncate: int, s: int, num_classes: int, device, mesh=None):
    """``--precision int8`` (JAX ``:159-195``), in the classification and
    t-SNE modes only: the PTQ encoder, calibrated on the calibration split
    (``calibration_inputs``) or loaded from ``--quantized_path``. Returns
    (model, apply_eval)."""
    if args.mode not in ("classification", "tsne", "tsne_interactive"):
        raise ValueError(
            "--precision int8 est disponible pour les modes "
            "classification/tsne/tsne_interactive uniquement"
        )
    from ._common import build_int8_family2, calibration_inputs

    cal, labeled = calibration_inputs(args, args.batch_size or cfg.batch_size, device, mesh)
    apply_eval, model = build_int8_family2(
        model, truncate, s, num_classes, cal, quantized_path=args.quantized_path,
        qat_steps=args.qat_steps, qat_lr=args.qat_lr, labeled_batches=labeled, mesh=mesh)
    return model, apply_eval


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_ported(args)
    cfg = GramAttentionConfig.from_json(args.config_path)
    mesh = None
    if args.mode in MESH_MODES:
        resolve = resolve_style_mesh if args.mode == "style_transfer" else resolve_eval_mesh
        mesh, launched = resolve(args, args.batch_size or cfg.batch_size, __spec__.name, argv)
        if launched:
            return
    with runtime_flags(args):
        _run(args, cfg, mesh)


def _run(args, cfg, mesh=None) -> None:
    device = resolve_device(args.device)
    if mesh is not None:
        device = mesh.device
    main_rank = mesh is None or mesh.is_main
    os.makedirs(args.save_dir, exist_ok=True)

    idx = ImageFolderIndex(os.path.join(args.data, "test"))
    num_classes = len(idx.classes)
    truncate = cfg.truncate_layer
    s = cfg.gram_matrix_size

    tree = family1_encoder_tree(
        load_checkpoint_tree(args.model_path, "gram_attention", cfg.to_dict()), truncate,
        num_classes, s, cfg.seed or 0)
    if args.afficher_params:
        total = count_params(tree)
        print(f"Nombre total de paramètres du modèle (TruncatedResNet50_for_test) : {total}")
    model = load_gram_attention(args.model_path, truncate, num_classes, s, device, tree=tree)
    del tree

    samples = maybe_subset(idx.samples, args.num_samples, agreed_seed(cfg.seed, mesh))
    loader = eval_loader(samples, args.batch_size or cfg.batch_size, mesh)
    dtype = resolve_compute_dtype(args.precision)

    def apply_eval(m, images):
        return gram_attention_apply(m, images, truncate, s, num_classes)

    int8_fn = None
    if args.precision == "int8":
        model, int8_fn = _int8(args, model, cfg, truncate, s, num_classes, device, mesh)
        apply_eval = int8_fn

    if args.mode == "classification":
        run_classification(model, loader, args.save_dir, truncate=truncate,
                           gram_matrix_size=s, num_classes=num_classes,
                           compute_dtype=dtype, compute_auc=args.compute_auc,
                           steps_per_dispatch=args.steps_per_dispatch, apply_fn=int8_fn,
                           mesh=mesh)
    elif args.mode in ("tsne", "tsne_interactive"):
        from ..tasks.embeddings import compute_embeddings_with_paths

        emb, labels, img_paths = compute_embeddings_with_paths(
            cast_forward(lambda m, images: apply_eval(m, images)[0], dtype), model, loader,
            samples, steps_per_dispatch=args.steps_per_dispatch, mesh=mesh)
        if not main_rank:  # rank 0 runs t-SNE
            return
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
            generator=torch.Generator().manual_seed(cfg.seed or 0), remat=args.remat,
            mesh=mesh,
        )
    else:
        from ..tasks.style_transfer import style_transfer_gram_attention

        style_transfer_gram_attention(
            model, loader, args.save_dir,
            layers=args.layers, threshold=args.threshold,
            num_iterations=args.num_iterations, learning_rate=args.learning_rate,
            truncate_layer=truncate, compute_dtype=dtype,
            generator=torch.Generator().manual_seed(cfg.seed or 0), remat=args.remat,
            mesh=mesh,
        )


if __name__ == "__main__":
    main()
