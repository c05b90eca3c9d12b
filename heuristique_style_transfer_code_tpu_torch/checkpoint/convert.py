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

from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.conv import hwio_to_oihw
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


def norm_modules(module: torch.nn.Module) -> set:
    """The names of ``module``'s submodules marked ``is_affine_norm``."""
    return {name for name, m in module.named_modules() if getattr(m, "is_affine_norm", False)}


def jax_path(key: str, ndim: int, norms: set) -> Tuple[List[str], Optional[Tuple[int, ...]]]:
    """(the JAX tree's path, the permutation from the port's layout to
    JAX's or None) of the state-dict entry ``key`` of rank ``ndim``
    (module docstring; ``norms`` from ``norm_modules``)."""
    parts = key.split(".")
    leaf, perm = parts[-1], None
    if leaf == "weight":
        if ".".join(parts[:-1]) in norms or ndim not in (2, 4):
            leaf = "scale"
        else:
            leaf, perm = "kernel", ((2, 3, 1, 0) if ndim == 4 else (1, 0))
    leaf = {"running_mean": "mean", "running_var": "var"}.get(leaf, leaf)
    return parts[:-1] + [leaf], perm


def none_paths(module: torch.nn.Module) -> List[List[str]]:
    """The JAX paths of the None leaves: each child that a module names in
    ``none_leaves`` and that is None."""
    out = []
    for name, m in module.named_modules():
        for leaf in getattr(m, "none_leaves", ()):
            if getattr(m, leaf) is None:
                out.append((name.split(".") if name else []) + [leaf])
    return out


def _host_f32(key: str, t: torch.Tensor, perm: Optional[Tuple[int, ...]]) -> np.ndarray:
    arr = t.detach().to("cpu", torch.float32, copy=True).numpy()  # owns its memory
    return np.ascontiguousarray(arr if perm is None else arr.transpose(perm))


def to_jax_tree(module: torch.nn.Module,
                tensors: Optional[Mapping[str, torch.Tensor]] = None,
                leaf_fn: Callable = _host_f32) -> Dict[str, Any]:
    """The port's module -> the JAX package's tree of numpy float32 arrays
    (what its ``save_pytree_npz`` writes). The ``weight`` of a module marked
    ``is_affine_norm`` is a norm's scale whatever its rank: a conditional
    net's (S, C) table stays (S, C), untransposed. A child that a module
    names in ``none_leaves`` and that is None becomes a None leaf.
    ``tensors`` ({state-dict key: tensor}, such as an optimiser's moments)
    is written in the layout of the module's own state, in its place.
    ``leaf_fn(key, tensor, perm)`` makes each leaf from its state-dict
    key, its tensor and ``jax_path``'s permutation (by default a float32
    host copy in JAX's layout)."""
    tree: Dict[str, Any] = {}
    norms = norm_modules(module)
    for key, t in (module.state_dict() if tensors is None else tensors).items():
        path, perm = jax_path(key, t.dim(), norms)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf_fn(key, t, perm)
    for path in none_paths(module):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = None
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
