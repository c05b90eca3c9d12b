"""Config schemas of model families 1, 2 and 3, JSON-compatible with the reference's
hyperparameter files (``config/schema.py`` of the JAX package). Unknown keys
are kept in ``extra`` and round-trip on save."""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Type, TypeVar

T = TypeVar("T", bound="_BaseConfig")


@dataclasses.dataclass
class _BaseConfig:
    batch_size: int = 32
    lr: float = 0.001
    seed: Optional[int] = None
    extra: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls: Type[T], d: dict) -> T:
        fields = {f.name for f in dataclasses.fields(cls)} - {"extra"}
        known = {k: v for k, v in d.items() if k in fields}
        extra = {k: v for k, v in d.items() if k not in fields}
        return cls(**known, extra=extra)

    @classmethod
    def from_json(cls: Type[T], path: str) -> T:
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        extra = d.pop("extra")
        out = {k: v for k, v in d.items() if v is not None}
        out.update(extra)
        return out

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=4)


@dataclasses.dataclass
class TruncatedResNetConfig(_BaseConfig):
    truncate_layer: int = 8
    dim: int = 256  # MoCo projection size (fixed 256 in the reference CLIs)


@dataclasses.dataclass
class GramAttentionConfig(_BaseConfig):
    truncate_layer: Optional[int] = None
    num_layers: Optional[int] = None  # reference alias for the truncation depth
    gram_matrix_size: int = 7
    num_classes: int = 4

    def __post_init__(self):
        # either key; absent both, the reference test CLI's default of 7
        if self.truncate_layer is None:
            self.truncate_layer = self.num_layers if self.num_layers is not None else 7


@dataclasses.dataclass
class MultiPatchGANConfig(_BaseConfig):
    patch_sizes: Dict[str, int] = dataclasses.field(
        default_factory=lambda: {"small": 10, "medium": 70, "large": 150}
    )
    num_classes: int = 4
    gram_matrix_dim: int = 64
    lambda_reg: float = 0.0
    pooling_type: str = "avg"
    ndf: int = 64
    norm: str = "batch"


_FAMILY = {
    "truncated_resnet50": TruncatedResNetConfig,
    "gram_attention": GramAttentionConfig,
    "multi_patchgan": MultiPatchGANConfig,
}


def load_config(family: str, path: str):
    return _FAMILY[family].from_json(path)
