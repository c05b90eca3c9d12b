"""Evaluation CLI, family 1, on PyTorch: the flags of
``heuristique_style_transfer_code_tpu/cli/test_truncated_resnet50.py`` plus
``--device`` (default ``cuda``; the counterpart of ``JAX_PLATFORMS``).

Ported: ``--mode classification`` (metrics.txt, confusion_matrix.png,
auc_score.txt with ``--compute_auc``, times_test.json with
``--measure_time``, the PNG tree with ``--save_test_images``, and with it
``--visualize_gradcam`` and ``--save_gradcam_images``
(``GradCAM_<label>/gradcam_<batch>_<row>.png``); ``--tensorboard`` logs
each saved image to ``save_dir/TensorBoard``),
``--mode inference`` (``inference_predictions.json``), ``--mode camera``
(a camera or a video file; ``--transport rgb|yuv420|yuv420_delta``,
``--device_preprocess``, ``--kalman_filter``, ``--save_camera_video``),
``--mode tsne|tsne_interactive|clustering`` (``<model>_embeddings.json``,
then ``tsne_plot.png``, the Tk GUI or its static fallback without
``DISPLAY``, or ``<class>_clustering_results.json``), ``--list_cameras``,
``--precision float32|bf16``, ``--steps_per_dispatch`` (classification,
inference and the embedding modes), ``--profile_dir`` and
``--debug_nans``. The flags listed in ``_NOT_PORTED`` raise a "not ported
yet" error.
``--model_path`` takes the JAX package's ``.npz`` or a reference ``.pth``
(``checkpoint/pth_converter.py``).

    python -m heuristique_style_transfer_code_tpu_torch.cli.test_truncated_resnet50 \\
        --data DATA --config_path cfg.json --model_path model.npz \\
        --mode classification --save_dir out [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..config.schema import TruncatedResNetConfig
from ..core.device import resolve_device
from ..data.imagefolder import ImageFolderIndex
from ..data.loader import HostLoader
from ..models.truncated_resnet50 import combined_apply, truncated_moco_apply
from ._common import (
    add_device_args,
    cast_forward,
    check_ported,
    count_params,
    load_checkpoint_tree,
    load_truncated_resnet50,
    make_writer,
    maybe_subset,
    resolve_class_names,
    resolve_compute_dtype,
    runtime_flags,
)

MODES = ["classification", "tsne", "tsne_interactive", "camera", "inference", "clustering"]
PORTED_MODES = ("classification", "inference", "camera", "tsne", "tsne_interactive",
                "clustering")

# flag -> its default; any other value raises "not ported yet"
_NOT_PORTED = {
    "devices": None,
}


def build_parser():
    parser = argparse.ArgumentParser(description="Truncated ResNet50 weather classifier (PyTorch)")
    parser.add_argument("--data", type=str)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--num_samples", type=int, default=None)
    parser.add_argument("--save_dir", default="results", type=str)
    parser.add_argument("--tensorboard", action="store_true")
    parser.add_argument("--save_camera_video", action="store_true")
    parser.add_argument("--prob_threshold", default=0.5, type=float)
    parser.add_argument("--visualize_gradcam", action="store_true")
    parser.add_argument("--save_gradcam_images", action="store_true")
    parser.add_argument("--measure_time", action="store_true")
    parser.add_argument("--mode", choices=MODES, default="classification")
    parser.add_argument("--colors", nargs="+", default=None)
    parser.add_argument("--clustering_class", type=str)
    parser.add_argument("--min_cluster_size", type=int, nargs="+", default=[10, 15, 20])
    parser.add_argument("--min_samples", type=int, nargs="+", default=[5, 10])
    parser.add_argument("--kalman_filter", action="store_true")
    parser.add_argument("--save_test_images", action="store_true")
    parser.add_argument("--test_data", type=str)
    parser.add_argument("--list_cameras", action="store_true")
    parser.add_argument("--camera_index", type=str, default="0")
    parser.add_argument("--transport", choices=["rgb", "yuv420", "yuv420_delta"], default="rgb",
                        help="Camera-mode frame transport: planar I420 halves the bytes to "
                        "the device (needs the host downscale); yuv420_delta ships its "
                        "temporal delta, reconstructed bit-exactly on the device")
    parser.add_argument("--device_preprocess", action="store_true",
                        help="Resize each frame on the device instead of downscaling it "
                        "on the host before the transfer")
    parser.add_argument("--colormap", type=str, default="hot")
    parser.add_argument("--compute_auc", action="store_true")
    parser.add_argument("--classes", nargs="+", type=str)
    parser.add_argument("--afficher_params", action="store_true")
    parser.add_argument("--inference_input", type=str,
                        help="Chemin vers un dossier d’images ou une image unique pour le "
                        "mode inference")
    parser.add_argument("--inference_json_name", type=str,
                        default="inference_predictions.json",
                        help="Nom du fichier JSON de sortie pour le mode inference")
    parser.add_argument("--num_workers", type=int, default=4,
                        help="Nombre de workers pour les DataLoader")
    add_device_args(parser, precisions=("float32", "bf16", "int8"))
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Évaluer K batches par aller-retour device (K batches envoyés "
                        "ensemble, leurs K passes lancées à la suite, une seule lecture — "
                        "résultats identiques). Incompatible avec --measure_time "
                        "(times_test.json est par batch)")
    parser.add_argument("--calib_data", type=str, default=None)
    parser.add_argument("--qat_steps", type=int, default=0)
    parser.add_argument("--qat_lr", type=float, default=1e-4)
    parser.add_argument("--quantized_path", type=str, default=None)
    return parser


def _check_ported(args) -> None:
    if args.mode not in PORTED_MODES:
        raise NotImplementedError(f"--mode {args.mode} is not ported yet ({', '.join(PORTED_MODES)})")
    check_ported(args, _NOT_PORTED)
    resolve_compute_dtype(args.precision)


def _inference_guards(args) -> None:
    """The JAX CLI's guards of ``--mode inference``, word for word."""
    if not args.inference_input:
        raise ValueError(
            "Le chemin --inference_input doit être spécifié pour le mode inference"
        )
    if args.steps_per_dispatch > 1 and args.measure_time:
        raise SystemExit(
            "--steps_per_dispatch > 1 dispatche K batches à la fois; le "
            "temps par image ne peut pas être mesuré — utilisez "
            "--steps_per_dispatch 1 avec --measure_time"
        )


def write_embeddings_json(emb, labels, model_path: str, save_dir: str) -> str:
    """``<model>_embeddings.json`` ({"embeddings", "labels"}), the model's
    file name without a checkpoint suffix (.pth, .pt, .npz, .orbax), as the
    JAX CLI names it."""
    base = os.path.basename(os.path.normpath(model_path))
    for suffix in (".pth", ".pt", ".npz", ".orbax"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
            break
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{base}_embeddings.json")
    with open(path, "w") as f:
        json.dump({"embeddings": np.asarray(emb).tolist(), "labels": np.asarray(labels).tolist()},
                  f)
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_ported(args)
    if args.mode == "inference":
        _inference_guards(args)
    with runtime_flags(args):
        _run(args)


def _run(args) -> None:
    writer = make_writer(args.tensorboard, args.save_dir, "TensorBoard")

    if args.list_cameras:
        from ..tasks.camera import list_available_cameras

        print(f"Caméras disponibles : {list_available_cameras()}")
        return

    device = resolve_device(args.device)
    cfg = TruncatedResNetConfig.from_json(args.config_path)
    class_names = resolve_class_names(args.classes, cfg.to_dict(), args.data)
    truncate = cfg.truncate_layer

    tree = load_checkpoint_tree(args.model_path, "truncated_resnet50", cfg.to_dict())
    model = load_truncated_resnet50(args.model_path, truncate, device, tree=tree)
    if args.afficher_params:
        print(f"Nombre total de paramètres du modèle (MoCo + Classifier) : {count_params(tree)}")
    del tree

    def forward_eval(m, images):
        return combined_apply(m.moco, m.classifier, images, truncate)

    def embed_fn(m, images):
        return truncated_moco_apply(m.moco, images, truncate)

    dtype = resolve_compute_dtype(args.precision)
    forward_eval = cast_forward(forward_eval, dtype)
    embed_fn = cast_forward(embed_fn, dtype)

    def make_loader():
        if not args.data:
            raise ValueError("Le chemin du dataset doit être spécifié pour ce mode")
        idx = ImageFolderIndex(os.path.join(args.data, "test"))
        samples = maybe_subset(idx.samples, args.num_samples, cfg.seed)
        return samples, HostLoader(samples, args.batch_size, shuffle=False,
                                   num_workers=args.num_workers)

    if args.mode == "inference":
        from ..tasks.inference import run_inference

        run_inference(forward_eval, model, args.inference_input, class_names, args.save_dir,
                      batch_size=args.batch_size, json_name=args.inference_json_name,
                      measure_time=args.measure_time, num_workers=args.num_workers,
                      steps_per_dispatch=args.steps_per_dispatch)

    elif args.mode == "classification":
        from ..tasks.classification import run_classification_test

        samples, loader = make_loader()
        gradcam_fn = None
        if args.visualize_gradcam:
            from ..tasks.gradcam import generate_heatmap_overlays, gradcam_moco

            # on the uncast f32 model, whatever --precision says, as JAX's
            # gradcam_moco takes the uncast variables
            def gradcam_fn(m, image_u8, target, img_path, out_path, colormap="hot"):
                cam = gradcam_moco(m, image_u8[None], [target], truncate=truncate)[0]
                return generate_heatmap_overlays(cam.cpu().numpy(), img_path, out_path, colormap)

        res = run_classification_test(
            forward_eval, model, loader, samples, class_names, args.save_dir,
            prob_threshold=args.prob_threshold, measure_time=args.measure_time,
            save_test_images=args.save_test_images, compute_auc=args.compute_auc,
            gradcam_fn=gradcam_fn, save_gradcam_images=args.save_gradcam_images,
            colormap=args.colormap, writer=writer,
            steps_per_dispatch=args.steps_per_dispatch,
        )
        print(
            f"Précision du test: {res['accuracy']}, Perte du test: {res['loss']}, "
            f"Précision: {res['precision']}, Rappel: {res['recall']}, Score F1: {res['f1']}"
        )
        if res["auc"] is not None:
            print(f"Score AUC: {res['auc']}")

    elif args.mode in ("tsne", "tsne_interactive", "clustering"):
        from ..tasks.embeddings import compute_embeddings_with_paths

        samples, loader = make_loader()
        emb, labels, img_paths = compute_embeddings_with_paths(
            embed_fn, model, loader, samples, steps_per_dispatch=args.steps_per_dispatch)
        write_embeddings_json(emb, labels, args.model_path, args.save_dir)
        if args.mode == "tsne":
            from ..tasks.tsne import perform_tsne

            perform_tsne(emb, labels, class_names, args.colors, args.save_dir)
        elif args.mode == "tsne_interactive":
            from ..tasks.tsne import plot_tsne_interactive

            plot_tsne_interactive(emb, labels, class_names, img_paths, args.colors,
                                  save_dir=args.save_dir)
        else:
            from ..tasks.clustering import run_clustering

            if not args.clustering_class:
                raise ValueError(
                    "L'option --clustering_class doit être spécifiée pour le mode clustering"
                )
            run_clustering(emb, labels, img_paths, class_names, args.clustering_class,
                           args.min_cluster_size, args.min_samples, args.save_dir, args.colors)

    else:
        from ..tasks.camera import run_camera

        cam_index = int(args.camera_index) if args.camera_index.isdigit() else args.camera_index
        run_camera(
            forward_eval, model, class_names,
            save_video=args.save_camera_video, save_dir=args.save_dir,
            prob_threshold=args.prob_threshold, measure_time=args.measure_time,
            kalman_filter=args.kalman_filter, camera_index=cam_index,
            host_downscale=not args.device_preprocess, transport=args.transport,
        )

    if writer:
        writer.close()


if __name__ == "__main__":
    main()
