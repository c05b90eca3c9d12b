"""Weight bridge between the JAX package's parameter trees and the port's
modules (``models/gram_attention.py``, ``models/truncated_resnet50.py``,
``models/multi_patchgan.py``, ``nn/transformer_net.py``).

The module tree mirrors the JAX tree, so a leaf's state-dict key is its
path with the leaf renamed:

    kernel (4-D, HWIO)   -> weight (OIHW)
    kernel (2-D, in,out) -> weight (out, in)
    scale / bias         -> weight / bias            (batch and instance norm;
                                                      (C,) or (S, C) tables)
    mean / var           -> running_mean / running_var
    in_proj_weight, ...  -> unchanged                (attention)

A None leaf of the JAX tree (a family-3 norm without parameters) is a
node with no parameters here: nothing to load, and ``to_jax_tree`` writes
it back as None where a module names it in ``none_leaves``. Loading fails
on any leaf left over or missing, and on any shape mismatch.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops.conv import hwio_to_oihw, oihw_to_hwio
from .io import _flatten, _listify

_RENAME = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
           "var": "running_var"}


def _to_torch_layout(leaf: str, arr: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and arr.ndim == 4:
        return hwio_to_oihw(arr)
    if leaf == "kernel" and arr.ndim == 2:
        return arr.T
    return arr


def from_jax_tree(tree: Any) -> Dict[str, torch.Tensor]:
    """JAX-layout tree of numpy arrays -> a state dict for the port's
    module (float32 CPU tensors; ``load_jax_tree`` moves them)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, arr in _flatten(tree).items():
        if path.endswith(".__none__"):  # a parameter-free node
            continue
        if path.endswith(("__empty_dict__", "__empty_list__")):
            raise KeyError(f"weight bridge: unexpected empty leaf {path!r}")
        parts = path.split("/")
        leaf = parts[-1]
        key = ".".join(parts[:-1] + [_RENAME.get(leaf, leaf)])
        sd[key] = torch.tensor(np.ascontiguousarray(_to_torch_layout(leaf, arr)))
    return sd


def to_jax_tree(module: torch.nn.Module) -> Dict[str, Any]:
    """The port's module -> the JAX package's tree of numpy float32 arrays
    (what its ``save_pytree_npz`` writes). The ``weight`` of a module marked
    ``is_affine_norm`` is a norm's scale whatever its rank: a conditional
    net's (S, C) table stays (S, C), untransposed. A child that a module
    names in ``none_leaves`` and that is None becomes a None leaf."""
    tree: Dict[str, Any] = {}
    inverse = {"running_mean": "mean", "running_var": "var"}
    norms = {name for name, m in module.named_modules() if getattr(m, "is_affine_norm", False)}
    for key, t in module.state_dict().items():
        parts = key.split(".")
        arr = t.detach().to("cpu", torch.float32).numpy()
        leaf = parts[-1]
        if leaf == "weight":
            if ".".join(parts[:-1]) in norms:
                leaf = "scale"
            elif arr.ndim == 4:
                leaf, arr = "kernel", oihw_to_hwio(arr)
            elif arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            else:  # batch-norm scale
                leaf = "scale"
        leaf = inverse.get(leaf, leaf)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    for name, m in module.named_modules():
        for leaf in getattr(m, "none_leaves", ()):
            if getattr(m, leaf) is None:
                node = tree
                for p in name.split(".") if name else ():
                    node = node.setdefault(p, {})
                node[leaf] = None
    return _listify(tree)


def load_jax_tree(module: torch.nn.Module, tree: Any) -> torch.nn.Module:
    """Copy a JAX-layout tree into ``module`` in place, keeping each
    parameter's device, dtype and memory format."""
    sd = from_jax_tree(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    extra = sorted(set(sd) - set(own))
    if missing or extra:
        raise KeyError(f"weight bridge: missing {missing}, left over {extra}")
    for key, t in sd.items():
        if tuple(t.shape) != tuple(own[key].shape):
            raise ValueError(
                f"weight bridge: {key} has shape {tuple(t.shape)}, "
                f"the module expects {tuple(own[key].shape)}"
            )
    with torch.no_grad():
        for key, t in sd.items():
            own[key].copy_(t)
    return module
