"""HDBSCAN clustering mode (``tasks/clustering.py`` of the JAX package,
copied: the port imports nothing of that package; the reference's
test_RESNET50_Truncate.py:171-229): one class's embeddings, a grid over
(min_cluster_size x min_samples) keeping the most clusters, the
<class>_clustering_results.json artifact, then the interactive t-SNE over
the clusters. scikit-learn (``sklearn.cluster.HDBSCAN``) is imported when
the mode runs.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np


def run_clustering(
    embeddings: np.ndarray,
    labels: np.ndarray,
    img_paths: List[str],
    class_names: List[str],
    clustering_class: str,
    min_cluster_sizes: Sequence[int] = (10, 15, 20),
    min_samples_list: Sequence[int] = (5, 10),
    save_dir: str = "results",
    colors: Optional[Sequence[str]] = None,
    interactive: bool = True,
) -> Dict:
    from sklearn.cluster import HDBSCAN

    class_index = class_names.index(clustering_class)
    labels = np.asarray(labels)
    mask = labels == class_index
    class_embeddings = np.asarray(embeddings)[mask]
    class_img_paths = [p for p, m in zip(img_paths, mask) if m]

    best_num, best_labels, best_params = 0, None, {}
    for mcs in min_cluster_sizes:
        for ms in min_samples_list:
            print(f"Testing HDBSCAN with min_cluster_size={mcs}, min_samples={ms}")
            # clamp BOTH knobs to the class size (the reference crashes on
            # small classes; sklearn needs min_samples ≤ n_samples and
            # min_cluster_size ≥ 2) and record what actually ran
            mcs_eff = min(mcs, max(2, len(class_embeddings)))
            ms_eff = min(ms, max(1, len(class_embeddings)))
            clustering = HDBSCAN(min_cluster_size=mcs_eff, min_samples=ms_eff).fit(
                class_embeddings
            )
            cl = clustering.labels_
            num = len(set(cl)) - (1 if -1 in cl else 0)
            print(f"Number of clusters found: {num}")
            if num > best_num:
                best_num, best_labels = num, cl
                best_params = {"min_cluster_size": mcs_eff, "min_samples": ms_eff}

    if best_labels is None:
        raise ValueError("No clusters found with the provided HDBSCAN parameters.")

    cluster_info = {}
    for label in set(best_labels.tolist()):
        idx = [i for i, l in enumerate(best_labels) if l == label]
        cluster_info[str(label)] = {
            "num_images": len(idx),
            "img_paths": [class_img_paths[i] for i in idx],
        }
    results = {
        "num_clusters": best_num,
        "clusters": cluster_info,
        "best_params": best_params,
    }
    os.makedirs(save_dir, exist_ok=True)
    out_path = os.path.join(save_dir, f"{clustering_class}_clustering_results.json")
    with open(out_path, "w") as f:
        json.dump(results, f)
    print(f"Clustering results saved in '{out_path}' with parameters {best_params}")

    if interactive:
        from .tsne import plot_tsne_interactive

        plot_tsne_interactive(
            class_embeddings,
            best_labels,
            [f"Cluster {i}" for i in range(best_num)] + ["Noise"],
            class_img_paths,
            colors=colors,
            num_clusters=best_num,
            save_dir=save_dir,
        )
    return results
