"""Host-side eval transform: Resize(size) -> ToTensor -> ImageNet Normalize.

The serving slice's copy of the JAX package's ``EvalTransform`` (the
reference's ``transform_no_augment``, ``util/data.py:762-766``), numpy path
only.  Output is HWC float32, the layout the port's model takes.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def resize(img: Image.Image, size: int) -> Image.Image:
    return img.resize((size, size), Image.BILINEAR)


def to_normalized_array(img: Image.Image) -> np.ndarray:
    """ToTensor + ImageNet Normalize, HWC float32."""
    x = np.asarray(img.convert("RGB"), np.uint8).astype(np.float32) / 255.0
    x -= np.asarray(IMAGENET_MEAN, np.float32)
    x /= np.asarray(IMAGENET_STD, np.float32)
    return x


class EvalTransform:
    """transform_no_augment: Resize(size) -> normalize (ref util/data.py:762-766)."""

    def __init__(self, image_size: int = 224):
        self.image_size = image_size

    def __call__(self, img: Image.Image) -> np.ndarray:
        return to_normalized_array(resize(img, self.image_size))
