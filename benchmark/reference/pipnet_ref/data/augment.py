"""The augmentation's constants and TrivialAugment spaces, without the
host's PIL operations (the device augmentation reads only the names,
magnitude bins and signs)."""

from __future__ import annotations

import numpy as np

NUM_BINS = 31
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
identity = brightness = color = contrast = sharpness = posterize = None
autocontrast = equalize = None

def _space_no_shape():
    """Photometric space with the fork's retuned ranges
    (ref util/data.py:929-952): Color is UNSIGNED over [-0.2, 1], Posterize
    range 8..4, no Solarize."""
    return {
        "Identity": (identity, np.zeros(1), False),
        "Brightness": (brightness, np.linspace(0.0, 0.5, NUM_BINS), True),
        "Color": (color, np.linspace(-0.2, 1.0, NUM_BINS), False),
        "Contrast": (contrast, np.linspace(0.0, 0.5, NUM_BINS), True),
        "Sharpness": (sharpness, np.linspace(0.0, 0.5, NUM_BINS), True),
        "Posterize": (posterize, 8 - np.round(np.arange(NUM_BINS) / ((NUM_BINS - 1) / 4)), False),
        "AutoContrast": (autocontrast, np.zeros(1), False),
        "Equalize": (equalize, np.zeros(1), False),
    }
