from .artifact import (
    InferenceArtifact,
    StyleArtifact,
    export_infer_artifact,
    export_style_artifact,
    load_infer_artifact,
    load_style_artifact,
    save_infer_artifact,
    save_style_artifact,
)

__all__ = [
    "InferenceArtifact",
    "StyleArtifact",
    "export_infer_artifact",
    "export_style_artifact",
    "load_infer_artifact",
    "load_style_artifact",
    "save_infer_artifact",
    "save_style_artifact",
]
