"""ImageFolder-compatible dataset index: sorted class dirs -> labels, sorted
file walk per class, as torchvision's ``datasets.ImageFolder`` and
``data/imagefolder.py`` of the JAX package."""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Tuple

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp")


@dataclass
class ImageFolderIndex:
    root: str
    classes: List[str] = field(default_factory=list)
    class_to_idx: dict = field(default_factory=dict)
    samples: List[Tuple[str, int]] = field(default_factory=list)

    def __post_init__(self):
        if self.samples:
            return
        self.classes = sorted(d.name for d in os.scandir(self.root) if d.is_dir())
        if not self.classes:
            raise FileNotFoundError(f"No class directories under {self.root}")
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        for cls in self.classes:
            for dirpath, _, filenames in sorted(os.walk(os.path.join(self.root, cls))):
                for fname in sorted(filenames):
                    if fname.lower().endswith(IMG_EXTENSIONS):
                        self.samples.append(
                            (os.path.join(dirpath, fname), self.class_to_idx[cls])
                        )
        if not self.samples:
            raise FileNotFoundError(f"No images under {self.root}")

    def __len__(self):
        return len(self.samples)

    def samples_per_class(self) -> dict:
        counts = {c: 0 for c in self.classes}
        for _, y in self.samples:
            counts[self.classes[y]] += 1
        return counts
