"""Flat-key ``.npz`` trees, the JAX package's checkpoint format
(``checkpoint/io.py:19-99``), read and written with numpy alone.

Keys are "/"-joined paths; list indices are digit components. Markers keep
what a flat file cannot hold: ``<path>.__none__`` for a None leaf,
``<path>.__empty_dict__`` and ``<path>.__empty_list__`` for empty
containers. A bfloat16 leaf is stored as 2-byte void (``V2``) bit patterns,
since numpy has no bfloat16: the reader widens it to the exact float32
values (a bf16 number is the top half of an f32 one).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

import numpy as np

_SEP = "/"
_MARKERS = {".__none__": None, ".__empty_dict__": dict, ".__empty_list__": list}


def _flatten(tree: Any, prefix: str = "", coerce=np.asarray) -> Dict[str, Any]:
    """{"/"-joined path: leaf} with the markers; ``coerce`` maps each real
    leaf (``np.asarray`` by default; ``sharded_io`` passes the identity, so
    a rank's shard stays what it is)."""
    flat: Dict[str, Any] = {}
    if isinstance(tree, dict):
        if not tree:
            flat[prefix[: -len(_SEP)] + ".__empty_dict__"] = np.zeros(0)
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}{_SEP}", coerce))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            flat[prefix[: -len(_SEP)] + ".__empty_list__"] = np.zeros(0)
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}{_SEP}", coerce))
    elif tree is None:
        flat[prefix[: -len(_SEP)] + ".__none__"] = np.zeros(0)
    else:
        flat[prefix[: -len(_SEP)]] = coerce(tree)
    return flat


def _unflatten(flat: Dict[str, np.ndarray]) -> Any:
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        for suffix, make in _MARKERS.items():
            if key.endswith(suffix):
                key = key[: -len(suffix)]
                val = make() if make is not None else None
                break
        parts = key.split(_SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def _listify(node: Any) -> Any:
    """Nested dicts whose keys are all digits become lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _listify(v) for k, v in node.items()}
    if out and all(k.isdigit() for k in out):
        return [out[str(i)] for i in range(len(out))]
    return out


def bf16_bits_to_f32(arr: np.ndarray) -> np.ndarray:
    """V2 (or uint16) bfloat16 bit patterns -> the same values in float32."""
    bits = arr.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def _decode(arr: np.ndarray) -> np.ndarray:
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return bf16_bits_to_f32(arr)
    return arr


def save_pytree_npz(tree: Any, path: str) -> None:
    """Atomic write (temp file in the same directory, then rename) of a tree
    of numpy arrays, dicts, lists and None."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    flat = _flatten(tree)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_pytree_npz(path: str) -> Any:
    """The tree of numpy arrays a ``save_pytree_npz`` (of either package)
    wrote; bf16 leaves come back as float32 holding the same values."""
    with np.load(path) as data:
        flat = {k: _decode(data[k]) for k in data.files}
    return _unflatten(flat)


def save_model_and_hyperparameters(tree: Any, hyperparameters: dict, save_dir: str,
                                   filename: str) -> str:
    """The artifact pair ``<filename>.npz`` + ``<filename>_hyperparameters.json``
    (``checkpoint/io.py:102-109`` of the JAX package); returns the npz path."""
    os.makedirs(save_dir, exist_ok=True)
    model_path = os.path.join(save_dir, f"{filename}.npz")
    save_pytree_npz(tree, model_path)
    with open(os.path.join(save_dir, f"{filename}_hyperparameters.json"), "w") as f:
        json.dump(hyperparameters, f, indent=4)
    return model_path


def load_hyperparameters(config_path: str) -> dict:
    with open(config_path, "r") as f:
        return json.load(f)
