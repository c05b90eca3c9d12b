"""JAX-layout tree -> reference .pth exporter (``checkpoint/pth_exporter.py``
of the JAX package; the reverse of ``pth_converter``).

A tree of either package (an ``.npz`` checkpoint, or ``convert.to_jax_tree``
of a port model) is re-emitted in the reference ecosystem's exact torch
layouts so it flows back into the torch CLIs unchanged:

- family 1: {'moco_model_state_dict', 'classifier_state_dict'} nested dicts
  with Sequential-positional truncated_encoder keys, consumable by
  ``load_best_model`` with strict=True
  (functions/functions_RESNET50_Truncate.py:177-221)
- family 2: {'truncated_encoder', 'classifier', 'attention'} component dicts,
  the ``save_model_weights`` layout consumed by ``load_model_weights``
  (functions/functions_RESNET50_Truncate_Gram_Attention.py:62-119)
- family 3: flat MultiScaleDiscriminator state_dicts (train and _test
  variants), consumable by ``model.load_state_dict(..., strict=True)``
  (train_best_Multi_PatchGAN.py:88-94, test_Multi_PatchGAN.py)

Layout transforms are the converter's inverses: conv HWIO -> OIHW, linear
(in,out) -> (out,in), BN scale/bias/mean/var -> weight/bias/running_mean/
running_var (+ a zero num_batches_tracked, required by strict loads);
attention weights are stored in torch layout already and pass through.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np

import torch

from ..nn.resnet import RESNET50_CHILDREN


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _conv_out(sd: Dict[str, np.ndarray], key: str, p: Dict[str, Any]):
    sd[f"{key}.weight"] = np.transpose(_np(p["kernel"]), (3, 2, 0, 1))
    if "bias" in p:
        sd[f"{key}.bias"] = _np(p["bias"])


def _linear_out(sd: Dict[str, np.ndarray], key: str, p: Dict[str, Any]):
    sd[f"{key}.weight"] = np.transpose(_np(p["kernel"]))
    sd[f"{key}.bias"] = _np(p["bias"])


def _bn_out(sd: Dict[str, np.ndarray], key: str, p: Dict[str, Any]):
    sd[f"{key}.weight"] = _np(p["scale"])
    sd[f"{key}.bias"] = _np(p["bias"])
    sd[f"{key}.running_mean"] = _np(p["mean"])
    sd[f"{key}.running_var"] = _np(p["var"])
    # torch BatchNorm state_dicts carry this counter; strict loads need the key
    sd[f"{key}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)


def _mha_out(sd: Dict[str, np.ndarray], key: str, p: Dict[str, Any]):
    sd[f"{key}.in_proj_weight"] = _np(p["in_proj_weight"])
    sd[f"{key}.in_proj_bias"] = _np(p["in_proj_bias"])
    sd[f"{key}.out_proj.weight"] = _np(p["out_proj_weight"])
    sd[f"{key}.out_proj.bias"] = _np(p["out_proj_bias"])


def _encoder_out(encoder: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    """Encoder pytree -> Sequential-positional torch keys (``0.weight`` for
    conv1 etc.), the state_dict layout of the reference's
    ``nn.Sequential(*children[:truncate])`` encoders."""
    sd: Dict[str, np.ndarray] = {}
    for name, params in encoder.items():
        idx = RESNET50_CHILDREN.index(name)
        base = f"{prefix}{idx}"
        if name == "conv1":
            _conv_out(sd, base, params)
        elif name == "bn1":
            _bn_out(sd, base, params)
        elif name.startswith("layer"):
            for b, block in enumerate(params):
                bb = f"{base}.{b}"
                for c in ("1", "2", "3"):
                    _conv_out(sd, f"{bb}.conv{c}", block[f"conv{c}"])
                    _bn_out(sd, f"{bb}.bn{c}", block[f"bn{c}"])
                if block.get("downsample") is not None:
                    _conv_out(sd, f"{bb}.downsample.0", block["downsample"]["conv"])
                    _bn_out(sd, f"{bb}.downsample.1", block["downsample"]["bn"])
        elif name == "fc":
            _linear_out(sd, base, params)
        else:
            raise KeyError(f"Unknown encoder child: {name}")
    return sd


# ----------------------------------------------------- family 1: TruncatedMoCo


def export_moco_checkpoint(tree: Dict[str, Any]) -> Dict[str, Any]:
    """{"moco": {encoder, fc}, "classifier": {fc}} -> the reference's nested
    best-checkpoint layout. The moco keys are ``truncated_encoder.<pos>...``
    plus its own ``fc.*`` projection; the classifier dict holds ``fc.*``."""
    moco_sd = _encoder_out(tree["moco"]["encoder"], prefix="truncated_encoder.")
    _linear_out(moco_sd, "fc", tree["moco"]["fc"])
    clf_sd: Dict[str, np.ndarray] = {}
    _linear_out(clf_sd, "fc", tree["classifier"]["fc"])
    return {"moco_model_state_dict": moco_sd, "classifier_state_dict": clf_sd}


# ------------------------------------------------- family 2: gram + attention


def export_gram_attention_checkpoint(tree: Dict[str, Any]) -> Dict[str, Any]:
    """{encoder, classifier, attention} -> the save_model_weights component
    layout (functions_RESNET50_Truncate_Gram_Attention.py:62-69). Component
    dicts use the modules' own key spaces (no prefix)."""
    out: Dict[str, Any] = {"truncated_encoder": _encoder_out(tree["encoder"])}
    clf_sd: Dict[str, np.ndarray] = {}
    clf = tree.get("classifier")
    if clf is not None:
        clf_sd["weight"] = np.transpose(_np(clf["kernel"]))
        clf_sd["bias"] = _np(clf["bias"])
    out["classifier"] = clf_sd
    att_sd: Dict[str, np.ndarray] = {}
    att = tree.get("attention")
    if att is not None:
        att_sd = {
            "in_proj_weight": _np(att["in_proj_weight"]),
            "in_proj_bias": _np(att["in_proj_bias"]),
            "out_proj.weight": _np(att["out_proj_weight"]),
            "out_proj.bias": _np(att["out_proj_bias"]),
        }
    out["attention"] = att_sd
    return out


# --------------------------------------------------- family 3: multi patchgan


def _patch_discriminator_out(
    sd: Dict[str, np.ndarray], prefix: str, disc: Dict[str, Any], norm: str
):
    idx = 0
    for entry in disc["convs"]:
        _conv_out(sd, f"{prefix}model.{idx}", entry["conv"])
        if norm == "batch" and entry.get("norm") is not None:
            _bn_out(sd, f"{prefix}model.{idx + 1}", entry["norm"])
        idx += 3  # conv, norm, leaky
    _conv_out(sd, f"{prefix}model.{idx}", disc["final"]["conv"])
    if norm == "batch" and disc["final"].get("norm") is not None:
        _bn_out(sd, f"{prefix}model.{idx + 1}", disc["final"]["norm"])
    _conv_out(sd, f"{prefix}model.{idx + 3}", disc["out_conv"])


def export_multi_patchgan_checkpoint(
    tree: Dict[str, Any], norm: str = "batch"
) -> Dict[str, np.ndarray]:
    """Train-variant pytree -> flat MultiScaleDiscriminator state_dict."""
    sd: Dict[str, np.ndarray] = {}
    for scale in ("small", "medium", "large"):
        _patch_discriminator_out(
            sd, f"scale_discriminators.{scale}.", tree[scale], norm
        )
    return sd


def _patch_discriminator_test_out(
    sd: Dict[str, np.ndarray], prefix: str, disc: Dict[str, Any], norm: str
):
    features = disc["features"]
    n_strided = len(features) - 2  # [...strided, final, final_ndf]
    for i in range(n_strided):
        _conv_out(sd, f"{prefix}feature_extractor.conv{i}", features[i]["conv"])
        if norm == "batch" and features[i].get("norm") is not None:
            _bn_out(sd, f"{prefix}feature_extractor.norm{i}", features[i]["norm"])
    _conv_out(sd, f"{prefix}feature_extractor.final_conv", features[n_strided]["conv"])
    if norm == "batch" and features[n_strided].get("norm") is not None:
        _bn_out(sd, f"{prefix}feature_extractor.final_norm", features[n_strided]["norm"])
    _conv_out(sd, f"{prefix}feature_extractor.final_conv_ndf", features[n_strided + 1]["conv"])
    for i, proj in enumerate(disc["projections"]):
        _conv_out(sd, f"{prefix}projection_layers.{i}", proj)
    _mha_out(sd, f"{prefix}attention_per_layer", disc["attention_per_layer"])
    _mha_out(sd, f"{prefix}attention_per_patch", disc["attention_per_patch"])
    _linear_out(sd, f"{prefix}classifier", disc["classifier"])
    _linear_out(sd, f"{prefix}feature_projection", disc["feature_projection"])


def export_multi_patchgan_test_checkpoint(
    tree: Dict[str, Any], norm: str = "batch"
) -> Dict[str, np.ndarray]:
    """Test-variant pytree -> flat MultiScaleDiscriminator_test state_dict."""
    sd: Dict[str, np.ndarray] = {}
    for scale in ("small", "medium", "large"):
        _patch_discriminator_test_out(
            sd, f"scale_discriminators.{scale}.", tree[scale], norm
        )
    return sd


# ----------------------------------------------------------------------- save


def export_checkpoint_tree(tree: Dict[str, Any], family: str, config: dict) -> Dict[str, Any]:
    """Family dispatch mirroring cli._common.load_checkpoint_tree."""
    if family == "truncated_resnet50":
        return export_moco_checkpoint(tree)
    if family == "gram_attention":
        return export_gram_attention_checkpoint(tree)
    if family == "multi_patchgan":
        return export_multi_patchgan_checkpoint(tree, norm=config.get("norm", "batch"))
    if family == "multi_patchgan_test":
        return export_multi_patchgan_test_checkpoint(tree, norm=config.get("norm", "batch"))
    raise ValueError(family)


def save_pth(state_dict: Dict[str, Any], path: str) -> None:
    """Write a (possibly nested) numpy state_dict as torch tensors."""
    def to_torch(d):
        if isinstance(d, dict):
            return {k: to_torch(v) for k, v in d.items()}
        # copy=True: torch.from_numpy needs a writable array
        return torch.from_numpy(np.array(d, copy=True))

    torch.save(to_torch(state_dict), path)
