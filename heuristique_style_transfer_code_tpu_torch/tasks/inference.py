"""Family-1 ``--mode inference``: classify unlabelled images
(``tasks/inference.py`` of the JAX package). A directory (walked
recursively) or one image file goes through the staged loader, the
device's ``eval_preprocess``, the model and a softmax in f32, into one JSON
(``inference_predictions.json``): per image its predicted class, score and
class probabilities, plus an optional ``timing`` block.
"""
from __future__ import annotations

import json
import os
from typing import Callable, List

import numpy as np
import torch

VALID_IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".webp")


def gather_inference_images(input_path: str) -> List[str]:
    """Image paths for ``--inference_input``: a supported single file, or a
    sorted recursive walk of a directory (the reference's error strings)."""
    if os.path.isfile(input_path):
        if input_path.lower().endswith(VALID_IMAGE_EXTENSIONS):
            return [input_path]
        raise ValueError(
            f"Le fichier fourni n'est pas une image supportée : {input_path}"
        )
    if os.path.isdir(input_path):
        image_paths = []
        for root, _, files in os.walk(input_path):
            for fname in files:
                if fname.lower().endswith(VALID_IMAGE_EXTENSIONS):
                    image_paths.append(os.path.join(root, fname))
        image_paths.sort()
        return image_paths
    raise ValueError(f"Chemin invalide pour l'inférence : {input_path}")


def run_inference(
    forward_eval: Callable,
    model,
    input_path: str,
    class_names: List[str],
    save_dir: str,
    *,
    batch_size: int = 32,
    json_name: str = "inference_predictions.json",
    measure_time: bool = False,
    mesh=None,
    steps_per_dispatch: int = 1,
    num_workers: int = 4,
) -> dict:
    """Gather, run each batch, write ``save_dir/json_name`` (num_images,
    classes, predictions, and with ``measure_time`` the timing block: one
    span a batch from the upload to the probabilities on the host; the
    loader's decode stays outside). Without ``measure_time``,
    ``steps_per_dispatch`` batches go up and come back together
    (``core/dispatch.py``; the CLI refuses the two together). On a
    data-parallel ``mesh`` the loader of image paths is split by rows
    (each rank decodes its rows of every batch), the probabilities are
    gathered and rank 0 alone writes the JSON (and prints). Returns the
    JSON's dict, on every rank."""
    from ..core.device import device_of
    from ..core.dispatch import dispatched_eval_iter
    from ..core.mesh import data_parallel
    from ..data.augment import eval_preprocess
    from ..data.loader import HostLoader

    main = mesh is None or mesh.is_main
    image_paths = gather_inference_images(input_path)
    if len(image_paths) == 0:
        raise ValueError(f"Aucune image trouvée dans : {input_path}")

    if main:
        os.makedirs(save_dir, exist_ok=True)
    loader = HostLoader([(p, 0) for p in image_paths], batch_size,
                        shuffle=False, num_workers=num_workers,
                        rows=None if data_parallel(mesh) is None else mesh.rows(batch_size))
    device = device_of(model)

    results: List[dict] = []
    total_time = 0.0
    total_images = 0

    def step(images_u8):
        return torch.softmax(forward_eval(model, eval_preprocess(images_u8)).float(), dim=-1)

    def on_span(seconds, batch):
        nonlocal total_time
        total_time += seconds

    with torch.inference_mode():
        outputs = dispatched_eval_iter(
            step, loader, device, steps_per_dispatch=1 if measure_time else steps_per_dispatch,
            mesh=mesh, on_span=on_span if measure_time else None)
        for batch, probs in outputs:
            n = batch["n_valid"]
            total_images += n
            for row in probs[:n]:
                pred_idx = int(np.argmax(row))
                results.append({
                    "image_path": image_paths[len(results)],
                    "predicted_class_index": pred_idx,
                    "predicted_class": class_names[pred_idx],
                    "predicted_probability": float(row[pred_idx]),
                    "class_probabilities": {
                        class_names[i]: float(row[i]) for i in range(len(class_names))
                    },
                })

    output_json = {
        "num_images": len(results),
        "classes": list(class_names),
        "predictions": results,
    }
    if measure_time and total_images > 0:
        output_json["timing"] = {
            "total_inference_time_seconds": float(total_time),
            "average_time_per_image_seconds": float(total_time / total_images),
        }

    if not main:
        return output_json
    output_path = os.path.join(save_dir, json_name)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(output_json, f, indent=2, ensure_ascii=False)

    print(f"Résultats d'inférence sauvegardés dans : {output_path}")
    print(f"Nombre d'images traitées : {len(results)}")
    if measure_time and total_images > 0:
        print(f"Temps total : {total_time:.4f} s")
        print(f"Temps moyen par image : {total_time / total_images:.6f} s")
    return output_json
