"""The hand-written CUDA kernels: ``gram`` (K1, K2) and ``instance_norm``
(K3). ``build_all`` compiles every source at once (one nvcc each);
``reset_launch_counts`` and ``launch_counts`` cover every kernel (the
banded K3/K3′ entry points of ``--shard_spatial`` where they launched).
Importing this package registers the ``hst`` ``torch.library`` ops, which
``torch.export.load`` of a program holding them needs first."""
from __future__ import annotations

from typing import Dict, List

from . import gram, instance_norm
from ._nvcc import build_all as _build_all

_MODULES = (gram, instance_norm)


def build_all() -> List[str]:
    """Build every kernel library (one nvcc process per source, started
    together); returns their paths."""
    return _build_all([m.LIBRARY for m in _MODULES])


def reset_launch_counts() -> None:
    for m in _MODULES:
        m.reset_launch_counts()


def launch_counts() -> Dict[str, int]:
    out: Dict[str, int] = {}
    for m in _MODULES:
        out.update(m.LAUNCHES)
    out.update({k: v for k, v in instance_norm.BAND_LAUNCHES.items() if v})
    return out
