"""ImageFolder scanning (torchvision-compatible layout, no torchvision dep).

Directory layout ``root/<class_name>/<image>``; classes are the sorted
directory names and labels their sorted index — identical to torchvision's
ImageFolder, which is what makes the reference's label order equal the sorted
class-name order (``util/data.py:656-658``)."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

IMG_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".gif", ".tiff", ".webp", ".ppm"}


@dataclass
class ImageFolder:
    root: str
    classes: List[str]
    class_to_idx: dict
    samples: List[Tuple[str, int]]          # (path, label)

    @property
    def targets(self) -> np.ndarray:
        return np.asarray([t for _, t in self.samples], np.int64)

    def __len__(self) -> int:
        return len(self.samples)

    def load(self, index: int) -> Tuple[Image.Image, int]:
        path, target = self.samples[index]
        with Image.open(path) as img:
            return img.convert("RGB"), target


def scan_image_folder(root: str, class_subset: Optional[Sequence[str]] = None) -> ImageFolder:
    classes = sorted(d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise FileNotFoundError(f"no class directories under {root}")
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples = []
    for c in classes:
        cdir = os.path.join(root, c)
        for fname in sorted(os.listdir(cdir)):
            if os.path.splitext(fname)[1].lower() in IMG_EXTENSIONS:
                samples.append((os.path.join(cdir, fname), class_to_idx[c]))
    if class_subset is not None:
        keep = {class_to_idx[c] for c in class_subset}
        samples = [(p, t) for p, t in samples if t in keep]
    return ImageFolder(root=root, classes=classes, class_to_idx=class_to_idx, samples=samples)
