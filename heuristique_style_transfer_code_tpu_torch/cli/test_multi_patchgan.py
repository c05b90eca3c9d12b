"""Evaluation CLI, family 3 (the multi-scale PatchGAN discriminators), on
PyTorch: the flags of
``heuristique_style_transfer_code_tpu/cli/test_multi_patchgan.py`` plus
``--device`` (default ``cuda``; the counterpart of ``JAX_PLATFORMS``).

Ported: ``--mode classification`` (``classification_results.json`` and
``confusion_matrix.png``; ``--compute_auc``, ``--measure_time``),
``--mode tsne`` (``tsne_plot.png``), ``--mode tsne_interactive`` (the Tk
GUI, or the static plot without ``DISPLAY``), ``--mode camera`` (a
camera or a video file, ``--classes`` required) and ``--mode
style_transfer`` (one image at a time, ``--threshold``,
``--learning_rate``, ``--num_iterations``;
``style_transfer_<date>/<label>/style_transfer_<label>_<n>_<ms>.png``),
with ``--precision float32|bf16``. ``--precision`` also sets the
classification forward's dtype, where the JAX CLI's classification step
runs float32 whatever it says. ``--model_path`` takes an ``.npz`` or a
reference ``.pth`` of the test variant, or a train-variant tree, which is
loaded partially as the JAX CLI loads it (``shape_filtered_update``).
``--steps_per_dispatch`` (classification and the t-SNE modes),
``--profile_dir`` and ``--debug_nans`` run. ``--devices N``
(classification and the t-SNE modes; style transfer's loader is b1, so it
stays on one device as JAX's clamp does; camera ignores it) runs N ranks,
one process a device (NCCL between cards, gloo with ``--device cpu``),
each decoding and running its rows of every batch; rank 0 writes the
files of ``--devices 1``. The flags listed in ``_NOT_PORTED`` raise a "not
ported yet" error.

    python -m heuristique_style_transfer_code_tpu_torch.cli.test_multi_patchgan \\
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

from ..checkpoint.convert import to_jax_tree
from ..config.schema import MultiPatchGANConfig
from ..core.device import device_of, resolve_device
from ..core.dispatch import dispatched_eval_iter
from ..data.augment import eval_preprocess
from ..data.imagefolder import ImageFolderIndex
from ..metrics.classification import confusion_matrix_np, weighted_precision_recall_f1
from ..models.multi_patchgan import multiscale_test_apply
from ._common import (
    add_device_args,
    agreed_seed,
    cast_forward,
    check_ported,
    count_params,
    eval_loader,
    load_checkpoint_tree,
    load_multi_patchgan,
    maybe_subset,
    resolve_compute_dtype,
    resolve_eval_mesh,
    resolve_style_mesh,
    runtime_flags,
    weighted_auc_or_none,
)

MODES = ["tsne", "tsne_interactive", "camera", "style_transfer", "classification"]
PORTED_MODES = ("classification", "tsne", "tsne_interactive", "camera", "style_transfer")
# the modes to which the JAX CLI passes a mesh: --devices N runs them on N ranks
MESH_MODES = ("classification", "tsne", "tsne_interactive", "style_transfer")

# flag -> its default; any other value raises "not ported yet"
_NOT_PORTED = {
    "shard_spatial": 1,
}


def build_parser():
    parser = argparse.ArgumentParser(description="Multi-scale PatchGAN classifier (PyTorch)")
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--config_path", type=str, required=True)
    parser.add_argument("--data", type=str, required=True)
    parser.add_argument("--num_samples", default=None, type=int)
    parser.add_argument("--batch_size", type=int, default=None,
                        help="Override the config batch size")
    parser.add_argument("--save_dir", default="results", type=str)
    parser.add_argument("--measure_time", action="store_true")
    parser.add_argument("--mode", type=str, choices=MODES, default="classification")
    parser.add_argument("--pooling_type", type=str, default="avg", choices=["avg", "max"])
    parser.add_argument("--save_camera_video", action="store_true")
    parser.add_argument("--prob_threshold", default=0.5, type=float)
    parser.add_argument("--classes", nargs="+", default=None)
    parser.add_argument("--colors", nargs="+")
    parser.add_argument("--layers", type=int, default=None,
                        help="(reference flag; its truncation path is broken upstream)")
    parser.add_argument("--threshold", default=1e-4, type=float)
    parser.add_argument("--learning_rate", default=0.01, type=float)
    parser.add_argument("--num_iterations", default=500, type=int)
    parser.add_argument("--shard_spatial", type=int, default=1, help="Not ported yet")
    parser.add_argument("--afficher_params", action="store_true")
    parser.add_argument("--compute_auc", action="store_true",
                        help="Calculer le score AUC pour le modèle")
    parser.add_argument("--camera_index", type=str, default="0")
    parser.add_argument("--device_preprocess", action="store_true",
                        help="Resize each frame on the device instead of downscaling it "
                        "on the host before the transfer")
    add_device_args(parser)
    parser.add_argument("--steps_per_dispatch", type=int, default=1,
                        help="Évaluer K batches par aller-retour device (K batches envoyés "
                        "ensemble, leurs K passes lancées à la suite, une seule lecture — "
                        "résultats identiques). Incompatible avec --measure_time "
                        "(times_test.json est par batch)")
    return parser


def _check_ported(args) -> None:
    if args.mode not in PORTED_MODES:
        raise NotImplementedError(f"--mode {args.mode} is not ported yet ({', '.join(PORTED_MODES)})")
    check_ported(args, _NOT_PORTED)


def evaluate(model, loader: Iterable[dict], *, gram_matrix_dim: int, norm: str,
             compute_dtype: Optional[torch.dtype] = None, measure_time: bool = False,
             steps_per_dispatch: int = 1, mesh=None) -> dict:
    """``--mode classification``'s device loop over ``HostLoader`` batches:
    staged uint8 up, ``eval_preprocess``, the three scales, the f32 softmax;
    argmax and probabilities come back in one fetch a batch. With
    ``measure_time`` one span a batch, from the upload to the fetch;
    otherwise ``steps_per_dispatch`` batches a round trip
    (``core/dispatch.py``), the same values. On a data-parallel ``mesh``
    the loader holds this rank's rows and the results are gathered. Returns the valid rows' preds,
    labels and probs, and the spans with each batch's valid count."""
    device = device_of(model)
    preds, labels, probs, spans = [], [], [], []

    def step(images_u8):
        images = eval_preprocess(images_u8)
        if compute_dtype is not None:
            images = images.to(compute_dtype)
        _, logits, _ = multiscale_test_apply(model, images, gram_matrix_dim, norm)
        pr = torch.softmax(logits.float(), dim=-1)
        return torch.cat([torch.argmax(logits, dim=-1, keepdim=True).float(), pr], dim=1)

    with torch.inference_mode():
        outputs = dispatched_eval_iter(
            step, loader, device, steps_per_dispatch=1 if measure_time else steps_per_dispatch,
            mesh=mesh, on_span=(lambda seconds, batch: spans.append((seconds, batch["n_valid"])))
            if measure_time else None)
        for batch, packed in outputs:
            n = batch["n_valid"]
            preds.extend(packed[:n, 0].astype(np.int64).tolist())
            labels.extend(np.asarray(batch["label"])[:n].tolist())
            probs.append(packed[:n, 1:])
    return {"preds": preds, "labels": labels, "probs": np.concatenate(probs), "spans": spans}


def classification_results(res: dict) -> dict:
    """The JSON's accuracy, weighted precision, recall and F1 (numpy, with
    scikit-learn's semantics), predictions and labels, printed as the JAX
    CLI prints them."""
    labels, preds = res["labels"], res["preds"]
    accuracy = float(np.mean(np.array(preds) == np.array(labels)))
    prf = weighted_precision_recall_f1(labels, preds)
    print(f"Accuracy: {accuracy:.4f}")
    print(f"Precision: {prf['precision']:.4f}")
    print(f"Recall: {prf['recall']:.4f}")
    print(f"F1 Score: {prf['f1_score']:.4f}")
    return {
        "accuracy": accuracy,
        "precision": prf["precision"],
        "recall": prf["recall"],
        "f1_score": prf["f1_score"],
        "predictions": [int(p) for p in preds],
        "labels": [int(label) for label in labels],
    }


def confusion_matrix_of(labels, preds) -> np.ndarray:
    """scikit-learn's ``confusion_matrix(labels, preds)``: rows and columns
    over the sorted union of the values present."""
    present = np.union1d(labels, preds)
    index = {int(v): i for i, v in enumerate(present)}
    return confusion_matrix_np([index[int(v)] for v in labels], [index[int(v)] for v in preds],
                               len(present))


def write_classification_results(results: dict, save_dir: str) -> str:
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, "classification_results.json")
    with open(path, "w") as f:
        json.dump(results, f, indent=4)
    print(f"Résultats de classification sauvegardés dans {path}")
    return path


def main(argv=None):
    args = build_parser().parse_args(argv)
    _check_ported(args)
    cfg = MultiPatchGANConfig.from_json(args.config_path)
    mesh = None
    if args.mode in MESH_MODES:
        if args.mode == "style_transfer":  # one image at a time: JAX's clamp gives 1 device
            mesh, launched = resolve_style_mesh(args, 1, __spec__.name, argv)
        else:
            mesh, launched = resolve_eval_mesh(args, args.batch_size or cfg.batch_size,
                                               __spec__.name, argv)
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

    gdim, norm = cfg.gram_matrix_dim, cfg.norm
    idx = ImageFolderIndex(os.path.join(args.data, "test"))
    classes = idx.classes
    samples = maybe_subset(idx.samples, args.num_samples, agreed_seed(cfg.seed, mesh))
    loader = eval_loader(samples, args.batch_size or cfg.batch_size, mesh, shuffle=False)

    tree = load_checkpoint_tree(args.model_path, "multi_patchgan_test", cfg.to_dict())
    model = load_multi_patchgan(args.model_path, cfg, device, tree=tree)
    del tree
    if args.afficher_params:  # the test architecture's, as loaded
        print("Nombre total de paramètres du modèle (MultiScaleDiscriminator_test) : "
              f"{count_params(to_jax_tree(model))}")
    dtype = resolve_compute_dtype(args.precision)

    def forward_eval(m, images):
        return multiscale_test_apply(m, images, gdim, norm)[1]

    def embed_fn(m, images):
        return multiscale_test_apply(m, images, gdim, norm)[0]

    if args.mode == "camera":
        from ..tasks.camera import run_camera

        if args.classes is None:
            raise ValueError(
                "Vous devez spécifier les classes avec l'option --classes en mode caméra."
            )
        cam_index = int(args.camera_index) if args.camera_index.isdigit() else args.camera_index
        run_camera(
            cast_forward(forward_eval, dtype), model, args.classes,
            save_video=args.save_camera_video, save_dir=args.save_dir,
            prob_threshold=args.prob_threshold, measure_time=args.measure_time,
            camera_index=cam_index, host_downscale=not args.device_preprocess,
        )

    elif args.mode == "style_transfer":
        from ..tasks.style_transfer import style_transfer_patches

        style_transfer_patches(
            model, eval_loader(samples, 1, mesh, shuffle=False), args.save_dir,
            gram_matrix_dim=gdim, norm=norm, layers=args.layers, threshold=args.threshold,
            num_iterations=args.num_iterations, learning_rate=args.learning_rate,
            compute_dtype=dtype, mesh=mesh,
        )

    elif args.mode in ("tsne", "tsne_interactive"):
        from ..tasks.embeddings import compute_embeddings_with_paths

        emb, labels, img_paths = compute_embeddings_with_paths(
            cast_forward(embed_fn, dtype), model, loader, samples,
            steps_per_dispatch=args.steps_per_dispatch, mesh=mesh)
        if not main_rank:  # rank 0 runs t-SNE
            return
        if args.mode == "tsne":
            from ..tasks.tsne import perform_tsne

            perform_tsne(emb, labels, classes, args.colors, args.save_dir)
        else:
            from ..tasks.tsne import plot_tsne_interactive

            plot_tsne_interactive(emb, labels, classes, img_paths, args.colors,
                                  save_dir=args.save_dir)

    else:
        from ..tasks.classification import plot_and_save_confusion_matrix

        if args.steps_per_dispatch > 1 and args.measure_time:
            raise SystemExit(
                "--steps_per_dispatch > 1 dispatche K batches à la fois; le "
                "temps par image ne peut pas être mesuré — utilisez "
                "--steps_per_dispatch 1 avec --measure_time"
            )
        res = evaluate(model, loader, gram_matrix_dim=gdim, norm=norm, compute_dtype=dtype,
                       measure_time=args.measure_time,
                       steps_per_dispatch=args.steps_per_dispatch, mesh=mesh)
        if not main_rank:  # rank 0 writes the results
            return
        if res["spans"]:  # per-image average, as the reference's evaluate_model_test
            print(f"Temps moyen par image: {np.mean([t / max(n, 1) for t, n in res['spans']]):.6f}"
                  " secondes")
        results = classification_results(res)
        plot_and_save_confusion_matrix(confusion_matrix_of(res["labels"], res["preds"]),
                                       classes, args.save_dir)
        if args.compute_auc:
            # the Multi-PatchGAN reference branches on the probability
            # matrix's width (test_Multi_PatchGAN.py:218-235)
            auc = weighted_auc_or_none(res["labels"], res["probs"], branch_on="probs")
            results["auc"] = auc
            if auc is not None:
                print(f"AUC Score: {auc:.4f}")
        write_classification_results(results, args.save_dir)


if __name__ == "__main__":
    main()
