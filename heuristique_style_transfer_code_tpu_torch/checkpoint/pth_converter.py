""".pth -> JAX-layout tree converter (``checkpoint/pth_converter.py`` of
the JAX package): loads the reference's PyTorch checkpoints into the tree of
numpy arrays that the weight bridge (``checkpoint/convert.load_jax_tree``)
consumes, for output parity (the BASELINE.json north-star requirement).

Replicates all four loader strategies of the reference (SURVEY.md §2.2 E12):
(a) split flat-vs-nested dicts with ``classifier. -> fc.`` rewrites
    (functions/functions_RESNET50_Truncate.py:177-221, load_best_model)
(b) raw torchvision resnet keys -> ``truncated_encoder.*`` prefix, skipping
    ``fc.`` (functions/functions_RESNET50_Truncate_Gram_Attention.py:29-58)
(c) component dicts {truncated_encoder, classifier, attention} with flat-key
    prefix-stripping fallback (same file :62-119)
(d) shape-filtered partial update (train_best_Multi_PatchGAN.py:88-94)

Layout transforms: conv OIHW -> HWIO, linear (out,in) -> (in,out); BN
weight/bias/running_mean/running_var -> scale/bias/mean/var;
num_batches_tracked dropped. MultiheadAttention packed weights are kept in
torch layout (ops/attention.py consumes them directly). The tree equals
the JAX package's converter's leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import torch

from ..nn.patch_discriminator import discriminator_layer_plan
from ..nn.resnet import RESNET50_CHILDREN

_STAGE_BLOCKS = {"layer1": 3, "layer2": 4, "layer3": 6, "layer4": 3}


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """Load a .pth file into {key: np.ndarray} without needing CUDA/torchvision."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return to_numpy_state_dict(obj)


def to_numpy_state_dict(obj) -> Dict[str, Any]:
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if isinstance(v, torch.Tensor):
                out[k] = v.detach().cpu().numpy()
            elif isinstance(v, dict):
                out[k] = to_numpy_state_dict(v)
            else:
                out[k] = v
        return out
    raise TypeError(f"Unsupported checkpoint object: {type(obj)}")


# ------------------------------------------------------------- leaf transforms


def _conv(sd, key) -> Dict[str, np.ndarray]:
    p = {"kernel": np.transpose(sd[f"{key}.weight"], (2, 3, 1, 0))}
    if f"{key}.bias" in sd:
        p["bias"] = sd[f"{key}.bias"]
    return p


def _linear(sd, key) -> Dict[str, np.ndarray]:
    return {"kernel": np.transpose(sd[f"{key}.weight"]), "bias": sd[f"{key}.bias"]}


def _bn(sd, key) -> Dict[str, np.ndarray]:
    return {
        "scale": sd[f"{key}.weight"],
        "bias": sd[f"{key}.bias"],
        "mean": sd[f"{key}.running_mean"],
        "var": sd[f"{key}.running_var"],
    }


def _mha(sd, key) -> Dict[str, np.ndarray]:
    return {
        "in_proj_weight": sd[f"{key}.in_proj_weight"],
        "in_proj_bias": sd[f"{key}.in_proj_bias"],
        "out_proj_weight": sd[f"{key}.out_proj.weight"],
        "out_proj_bias": sd[f"{key}.out_proj.bias"],
    }


# --------------------------------------------------------------- resnet mapping


def _normalize_resnet_keys(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, np.ndarray]:
    """Strip ``prefix`` and rewrite Sequential positional indices (``0.weight``)
    to torchvision child names (``conv1.weight``)."""
    out = {}
    for k, v in sd.items():
        if prefix:
            if not k.startswith(prefix):
                continue
            k = k[len(prefix):]
        parts = k.split(".")
        if parts[0].isdigit():
            idx = int(parts[0])
            parts[0] = RESNET50_CHILDREN[idx]
        out[".".join(parts)] = v
    return out


def convert_resnet_children(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict[str, Any]:
    """Torch resnet50 (full or truncated, named or positional keys) -> encoder
    pytree matching nn/resnet.py. Only children present in ``sd`` appear."""
    sd = _normalize_resnet_keys(sd, prefix)
    tree: Dict[str, Any] = {}
    if "conv1.weight" in sd:
        tree["conv1"] = _conv(sd, "conv1")
    if "bn1.weight" in sd:
        tree["bn1"] = _bn(sd, "bn1")
    for stage, n_blocks in _STAGE_BLOCKS.items():
        if not any(k.startswith(f"{stage}.") for k in sd):
            continue
        blocks: List[Dict[str, Any]] = []
        for b in range(n_blocks):
            base = f"{stage}.{b}"
            if f"{base}.conv1.weight" not in sd:
                break
            block = {
                "conv1": _conv(sd, f"{base}.conv1"),
                "bn1": _bn(sd, f"{base}.bn1"),
                "conv2": _conv(sd, f"{base}.conv2"),
                "bn2": _bn(sd, f"{base}.bn2"),
                "conv3": _conv(sd, f"{base}.conv3"),
                "bn3": _bn(sd, f"{base}.bn3"),
            }
            if f"{base}.downsample.0.weight" in sd:
                block["downsample"] = {
                    "conv": _conv(sd, f"{base}.downsample.0"),
                    "bn": _bn(sd, f"{base}.downsample.1"),
                }
            blocks.append(block)
        tree[stage] = blocks
    if "fc.weight" in sd:
        tree["fc"] = _linear(sd, "fc")
    return tree


# ----------------------------------------------------- family 1: TruncatedMoCo


def convert_moco_checkpoint(path_or_sd) -> Dict[str, Any]:
    """Strategy (a): returns {"moco": {encoder, fc}, "classifier": {fc}}.

    Accepts both the nested {'moco_model_state_dict', 'classifier_state_dict'}
    layout and a flat state_dict that mixes both models
    (functions/functions_RESNET50_Truncate.py:177-216).
    """
    sd = load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    if "moco_model_state_dict" in sd and "classifier_state_dict" in sd:
        moco_sd = sd["moco_model_state_dict"]
        clf_sd = sd["classifier_state_dict"]
    else:
        moco_sd = {k: v for k, v in sd.items() if not k.startswith("classifier.")}
        clf_sd = {}
        for k, v in sd.items():
            if k.startswith("classifier."):
                clf_sd[k.replace("classifier.", "fc.")] = v
        # flat moco dicts may also carry their own fc.* (the 256-d projection)
    encoder = convert_resnet_children(moco_sd, prefix="truncated_encoder.")
    moco = {"encoder": encoder, "fc": _linear(moco_sd, "fc")}
    if "fc.weight" not in clf_sd and "classifier_state_dict" not in sd:
        # moco-only checkpoint: the updated reference tolerates this (each
        # fold gets a fresh classifier with a console note,
        # train_best_RESNET50_Truncate.py:172-174) — return just the moco
        # tree and let the caller initialise the classifier
        return {"moco": moco}
    classifier = {"fc": _linear(clf_sd, "fc")}
    return {"moco": moco, "classifier": classifier}


# ------------------------------------------------- family 2: gram + attention


def convert_gram_attention_checkpoint(path_or_sd) -> Dict[str, Any]:
    """Strategies (b) and (c): returns {encoder, classifier, attention} matching
    models/gram_attention.py. Handles:
    - component dicts {'truncated_encoder': {...}, 'classifier': {...},
      'attention': {...}} (save_model_weights layout, :62-69)
    - flat keys with truncated_encoder./classifier./attention. prefixes (:98-115)
    - a raw torchvision resnet50 state_dict (load_model, :29-58) — encoder only.
    """
    sd = load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd

    if isinstance(sd.get("truncated_encoder"), dict):
        enc_sd = sd["truncated_encoder"]
        clf_sd = sd.get("classifier", {})
        att_sd = sd.get("attention", {})
    elif any(k.startswith("truncated_encoder.") for k in sd):
        enc_sd = {
            k[len("truncated_encoder."):]: v
            for k, v in sd.items()
            if k.startswith("truncated_encoder.")
        }
        clf_sd = {
            k[len("classifier."):]: v for k, v in sd.items() if k.startswith("classifier.")
        }
        att_sd = {
            k[len("attention."):]: v for k, v in sd.items() if k.startswith("attention.")
        }
    else:
        # raw torchvision resnet: take everything except its fc head
        enc_sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
        clf_sd, att_sd = {}, {}

    out: Dict[str, Any] = {"encoder": convert_resnet_children(enc_sd)}
    if "weight" in clf_sd:
        out["classifier"] = {"kernel": np.transpose(clf_sd["weight"]), "bias": clf_sd["bias"]}
    if "in_proj_weight" in att_sd:
        out["attention"] = {
            "in_proj_weight": att_sd["in_proj_weight"],
            "in_proj_bias": att_sd["in_proj_bias"],
            "out_proj_weight": att_sd["out_proj.weight"],
            "out_proj_bias": att_sd["out_proj.bias"],
        }
    return out


# --------------------------------------------------- family 3: multi patchgan


def _convert_patch_discriminator(sd: Dict[str, np.ndarray], prefix: str,
                                 patch_size: int, ndf: int, input_nc: int,
                                 norm: str) -> Dict[str, Any]:
    """Train variant: Sequential 'model' with positional indices; convs at
    stride-2 positions, then final conv, norm, leaky, out conv
    (Models/Models_Multi_PatchGAN.py:33-54). Instance norm has no params but
    still consumes an index."""
    strided, _, _ = discriminator_layer_plan(patch_size, ndf, input_nc)
    idx = 0
    convs = []
    for _ in strided:
        entry = {"conv": _conv(sd, f"{prefix}model.{idx}")}
        entry["norm"] = _bn(sd, f"{prefix}model.{idx + 1}") if norm == "batch" else None
        convs.append(entry)
        idx += 3  # conv, norm, leaky
    final = {"conv": _conv(sd, f"{prefix}model.{idx}")}
    final["norm"] = _bn(sd, f"{prefix}model.{idx + 1}") if norm == "batch" else None
    out_conv = _conv(sd, f"{prefix}model.{idx + 3}")
    return {"convs": convs, "final": final, "out_conv": out_conv}


def convert_multi_patchgan_checkpoint(
    path_or_sd, patch_sizes: Dict[str, int], ndf: int = 64, input_nc: int = 3,
    norm: str = "batch",
) -> Dict[str, Any]:
    """MultiScaleDiscriminator (train variant) state_dict -> pytree."""
    sd = load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    return {
        scale: _convert_patch_discriminator(
            sd, f"scale_discriminators.{scale}.", patch_sizes.get(scale, 70),
            ndf, input_nc, norm,
        )
        for scale in ("small", "medium", "large")
    }


def _convert_patch_discriminator_test(
    sd: Dict[str, np.ndarray], prefix: str, patch_size: int, ndf: int,
    input_nc: int, norm: str,
) -> Dict[str, Any]:
    strided, _, _ = discriminator_layer_plan(patch_size, ndf, input_nc)
    features = []
    for i in range(len(strided)):
        entry = {"conv": _conv(sd, f"{prefix}feature_extractor.conv{i}")}
        entry["norm"] = (
            _bn(sd, f"{prefix}feature_extractor.norm{i}") if norm == "batch" else None
        )
        features.append(entry)
    final = {"conv": _conv(sd, f"{prefix}feature_extractor.final_conv")}
    final["norm"] = (
        _bn(sd, f"{prefix}feature_extractor.final_norm") if norm == "batch" else None
    )
    features.append(final)
    features.append({"conv": _conv(sd, f"{prefix}feature_extractor.final_conv_ndf"), "norm": None})
    n_proj = len(strided) + 2
    return {
        "features": features,
        "projections": [_conv(sd, f"{prefix}projection_layers.{i}") for i in range(n_proj)],
        "attention_per_layer": _mha(sd, f"{prefix}attention_per_layer"),
        "attention_per_patch": _mha(sd, f"{prefix}attention_per_patch"),
        "classifier": _linear(sd, f"{prefix}classifier"),
        "feature_projection": _linear(sd, f"{prefix}feature_projection"),
    }


def convert_multi_patchgan_test_checkpoint(
    path_or_sd, patch_sizes: Dict[str, int], ndf: int = 64, input_nc: int = 3,
    norm: str = "batch",
) -> Dict[str, Any]:
    sd = load_torch_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    return {
        scale: _convert_patch_discriminator_test(
            sd, f"scale_discriminators.{scale}.", patch_sizes.get(scale, 70),
            ndf, input_nc, norm,
        )
        for scale in ("small", "medium", "large")
    }


# --------------------------------------------------------- strategy (d): shape


def shape_filtered_update(target: Any, source: Any, stats: Optional[dict] = None) -> Any:
    """Strategy (d): overwrite target leaves with same-path same-shape source
    leaves, keep the rest (train_best_Multi_PatchGAN.py:88-94).

    Pass ``stats={}`` to collect {'loaded': n, 'total': m} so callers can
    report how much of the checkpoint actually matched (a silent near-zero
    match usually means the wrong checkpoint)."""
    if isinstance(target, dict) and isinstance(source, dict):
        return {
            k: shape_filtered_update(v, source[k], stats) if k in source
            else _count_only(v, stats)
            for k, v in target.items()
        }
    if isinstance(target, (list, tuple)) and isinstance(source, (list, tuple)):
        return type(target)(  # preserve list vs tuple: pytree structure
            shape_filtered_update(t, source[i], stats) if i < len(source)
            else _count_only(t, stats)
            for i, t in enumerate(target)
        )
    if target is None or source is None:
        return target
    if hasattr(target, "shape"):
        if stats is not None:
            stats["total"] = stats.get("total", 0) + 1
        if hasattr(source, "shape") and tuple(target.shape) == tuple(source.shape):
            if stats is not None:
                stats["loaded"] = stats.get("loaded", 0) + 1
            return source
    return target


def _count_only(tree: Any, stats: Optional[dict]):
    if stats is not None:
        for leaf in _iter_leaves(tree):
            if hasattr(leaf, "shape"):
                stats["total"] = stats.get("total", 0) + 1
    return tree


def _iter_leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _iter_leaves(v)
    else:
        yield tree
