"""Host-side augmentation ops, the TrivialAugment variants and the
two-view / eval transforms.

The port's copy of the JAX package's ``data/augment.py``: the reference's
transform recipes (``util/data.py:757-814``) and its customized
TrivialAugmentWide spaces (``util/data.py:904-954``), implemented directly on
PIL (torchvision is not a dependency):

* ``TrivialAugmentWideNoColor``  -- geometric only (shear/translate/rotate),
  used as transform1 (shared geometry between the two views);
* ``TrivialAugmentWideNoShape``  -- photometric only, retuned ranges, used as
  transform2 (independent per view);
* ``TrivialAugmentWideNoShapeWithColor`` -- CARS variant with Solarize/Color.

TrivialAugment semantics (arXiv:2103.10158, as in torchvision): pick ONE op
uniformly, pick a strength bin uniformly from 31 bins, flip sign with p=0.5
for signed ops.  Randomness comes from the caller's ``np.random.Generator``.
Arrays come out HWC float32, the layout the port's model takes.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

from ..native import normalize_u8

NUM_BINS = 31
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# primitive ops (torchvision functional parity on PIL images)
# ---------------------------------------------------------------------------

def _affine(img: Image.Image, angle: float = 0.0, translate=(0, 0),
            shear=(0.0, 0.0)) -> Image.Image:
    """Affine warp about the image center (torchvision F.affine semantics:
    inverse matrix of translate @ center-rotate-shear)."""
    w, h = img.size
    cx, cy = w * 0.5, h * 0.5
    rot = math.radians(angle)
    sx, sy = (math.radians(s) for s in shear)
    # forward matrix M = T(translate) T(center) R(rot) Sh(sx, sy) T(-center)
    a = math.cos(rot - sy) / math.cos(sy)
    b = -math.cos(rot - sy) * math.tan(sx) / math.cos(sy) - math.sin(rot)
    c = math.sin(rot - sy) / math.cos(sy)
    d = -math.sin(rot - sy) * math.tan(sx) / math.cos(sy) + math.cos(rot)
    # inverse (PIL's transform wants output->input mapping)
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    tx, ty = translate
    # map output (x,y): first undo final translation+center, then inverse linear, then add center
    m0, m1 = ia, ib
    m3, m4 = ic, id_
    m2 = cx - m0 * (cx + tx) - m1 * (cy + ty)
    m5 = cy - m3 * (cx + tx) - m4 * (cy + ty)
    return img.transform((w, h), Image.AFFINE, (m0, m1, m2, m3, m4, m5),
                         resample=Image.NEAREST)


def shear_x(img, mag):
    return _affine(img, shear=(math.degrees(math.atan(mag)), 0.0))


def shear_y(img, mag):
    return _affine(img, shear=(0.0, math.degrees(math.atan(mag))))


def translate_x(img, mag):
    return _affine(img, translate=(int(round(mag)), 0))


def translate_y(img, mag):
    return _affine(img, translate=(0, int(round(mag))))


def rotate(img, mag):
    return _affine(img, angle=mag)


def brightness(img, mag):
    return ImageEnhance.Brightness(img).enhance(1.0 + mag)


def color(img, mag):
    return ImageEnhance.Color(img).enhance(1.0 + mag)


def contrast(img, mag):
    return ImageEnhance.Contrast(img).enhance(1.0 + mag)


def sharpness(img, mag):
    return ImageEnhance.Sharpness(img).enhance(1.0 + mag)


def posterize(img, mag):
    return ImageOps.posterize(img, int(mag))


def solarize(img, mag):
    return ImageOps.solarize(img, int(mag))


def autocontrast(img, _):
    return ImageOps.autocontrast(img)


def equalize(img, _):
    return ImageOps.equalize(img)


def identity(img, _):
    return img


# op name -> (fn, bins array, signed)
AugSpace = Dict[str, Tuple[Callable, np.ndarray, bool]]


def _space_no_color() -> AugSpace:
    """Geometric space (ref util/data.py:904-913)."""
    return {
        "Identity": (identity, np.zeros(1), False),
        "ShearX": (shear_x, np.linspace(0.0, 0.5, NUM_BINS), True),
        "ShearY": (shear_y, np.linspace(0.0, 0.5, NUM_BINS), True),
        "TranslateX": (translate_x, np.linspace(0.0, 16.0, NUM_BINS), True),
        "TranslateY": (translate_y, np.linspace(0.0, 16.0, NUM_BINS), True),
        "Rotate": (rotate, np.linspace(0.0, 60.0, NUM_BINS), True),
    }


def _space_no_shape() -> AugSpace:
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


def _space_no_shape_with_color() -> AugSpace:
    """CARS photometric space (ref util/data.py:915-927)."""
    return {
        "Identity": (identity, np.zeros(1), False),
        "Brightness": (brightness, np.linspace(0.0, 0.5, NUM_BINS), True),
        "Color": (color, np.linspace(0.0, 0.5, NUM_BINS), True),
        "Contrast": (contrast, np.linspace(0.0, 0.5, NUM_BINS), True),
        "Sharpness": (sharpness, np.linspace(0.0, 0.5, NUM_BINS), True),
        "Posterize": (posterize, 8 - np.round(np.arange(NUM_BINS) / ((NUM_BINS - 1) / 6)), False),
        "Solarize": (solarize, np.linspace(255.0, 0.0, NUM_BINS), False),
        "AutoContrast": (autocontrast, np.zeros(1), False),
        "Equalize": (equalize, np.zeros(1), False),
    }


class TrivialAugment:
    """Apply one uniformly-chosen op at a uniformly-chosen strength."""

    def __init__(self, space: AugSpace):
        self.space = space
        self.names = list(space.keys())

    def __call__(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        name = self.names[rng.integers(len(self.names))]
        fn, bins, signed = self.space[name]
        mag = float(bins[rng.integers(len(bins))]) if len(bins) > 1 else float(bins[0])
        if signed and rng.integers(2):
            mag = -mag
        return fn(img, mag)


def trivial_augment_no_color() -> TrivialAugment:
    return TrivialAugment(_space_no_color())


def trivial_augment_no_shape() -> TrivialAugment:
    return TrivialAugment(_space_no_shape())


def trivial_augment_no_shape_with_color() -> TrivialAugment:
    return TrivialAugment(_space_no_shape_with_color())


# ---------------------------------------------------------------------------
# composed transforms (the reference's transform1 / transform1p / transform2)
# ---------------------------------------------------------------------------

def resize(img: Image.Image, size: int) -> Image.Image:
    return img.resize((size, size), Image.BILINEAR)


def random_resized_crop(img: Image.Image, out_size: int, rng: np.random.Generator,
                        scale=(0.95, 1.0), ratio=(3 / 4, 4 / 3)) -> Image.Image:
    """torchvision RandomResizedCrop semantics: 10 tries of (area, log-ratio)
    sampling, center-crop fallback."""
    w, h = img.size
    area = w * h
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = math.exp(rng.uniform(math.log(ratio[0]), math.log(ratio[1])))
        cw = int(round(math.sqrt(target * ar)))
        ch = int(round(math.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            x = int(rng.integers(0, w - cw + 1))
            y = int(rng.integers(0, h - ch + 1))
            return img.resize((out_size, out_size), Image.BILINEAR,
                              box=(x, y, x + cw, y + ch))
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    x, y = (w - cw) // 2, (h - ch) // 2
    return img.resize((out_size, out_size), Image.BILINEAR, box=(x, y, x + cw, y + ch))


def random_crop(img: Image.Image, out_size: int, rng: np.random.Generator) -> Image.Image:
    w, h = img.size
    x = int(rng.integers(0, w - out_size + 1)) if w > out_size else 0
    y = int(rng.integers(0, h - out_size + 1)) if h > out_size else 0
    return img.crop((x, y, x + out_size, y + out_size))


def to_normalized_array(img: Image.Image, grayscale: bool = False) -> np.ndarray:
    """ToTensor + ImageNet Normalize, HWC float32, through the native
    single-pass normalizer (``native.normalize_u8``: within 1e-6 of the numpy
    expression ``(x / 255 - mean) / std``, as it multiplies by reciprocals)."""
    if grayscale:
        img = img.convert("L").convert("RGB")
    return normalize_u8(np.asarray(img.convert("RGB"), np.uint8))


class TwoViewTransform:
    """The birds recipe (ref util/data.py:768-809):

    transform1 (shared geometry):  Resize(size+8) -> TA-NoColor -> HFlip ->
                                   RandomResizedCrop(size+4, scale .95-1)
    transform1p (pretraining):     Resize(size+32) -> same tail
    transform2 (per view):         TA-NoShape -> RandomCrop(size) -> normalize

    ``disable_transform2`` reproduces the reference's variant (crop straight
    to ``size`` in transform1, no photometric second stage).
    """

    def __init__(self, image_size: int = 224, pretrain: bool = False,
                 disable_transform2: bool = False, cars: bool = False,
                 grayscale: bool = False):
        self.image_size = image_size
        self.resize_to = image_size + (32 if (pretrain or cars) else 8)
        self.disable_transform2 = disable_transform2
        self.crop_to = image_size if disable_transform2 else image_size + 4
        self.ta_geo = trivial_augment_no_color()
        self.ta_photo = (trivial_augment_no_shape_with_color() if cars
                         else trivial_augment_no_shape())
        self.grayscale = grayscale

    def transform1(self, img: Image.Image, rng: np.random.Generator) -> Image.Image:
        img = resize(img, self.resize_to)
        img = self.ta_geo(img, rng)
        if rng.integers(2):
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        return random_resized_crop(img, self.crop_to, rng)

    def transform2(self, img: Image.Image, rng: np.random.Generator) -> np.ndarray:
        if self.disable_transform2:
            return to_normalized_array(img, self.grayscale)
        img = self.ta_photo(img, rng)
        img = random_crop(img, self.image_size, rng)
        return to_normalized_array(img, self.grayscale)

    def __call__(self, img: Image.Image, rng: np.random.Generator):
        """One shared geometric view, two independent photometric views
        (ref TwoAugSupervisedDataset.__getitem__, util/data.py:895-898)."""
        shared = self.transform1(img, rng)
        return self.transform2(shared, rng), self.transform2(shared, rng)

    @property
    def supports_device_photometric(self) -> bool:
        """transform2 can run on the device (ops/device_augment) for the
        standard recipes; grayscale / disable_transform2 stay host-side."""
        return not (self.disable_transform2 or self.grayscale)

    @property
    def supports_device_geometric(self) -> bool:
        """transform1 can ALSO run on the device (ops/device_geometric) for
        the standard recipes — the host then only decodes + resizes (cached).
        CARS keeps transform1 on the device too (only resize_to differs)."""
        return self.supports_device_photometric

    def geometric_view(self, img: Image.Image, rng: np.random.Generator) -> np.ndarray:
        """transform1 only, as uint8 HWC (crop_to, crop_to, 3) — the shared
        geometric view shipped to the device, which derives BOTH photometric
        views there (ops/device_augment.two_view_transform2).  4x smaller H2D
        than one normalized f32 view and removes 2x per-view PIL photometric
        work from the 1-core host."""
        return np.asarray(self.transform1(img, rng).convert("RGB"), np.uint8)

    def base_view(self, img: Image.Image) -> np.ndarray:
        """Resize(resize_to) only, as uint8 HWC — the deterministic base the
        device-side transform1 (ops/device_geometric.transform1_batch) warps.
        Deterministic per image, so the loader caches it across epochs."""
        return np.asarray(resize(img, self.resize_to).convert("RGB"), np.uint8)


class EvalTransform:
    """transform_no_augment: Resize(size) -> normalize (ref util/data.py:762-766)."""

    def __init__(self, image_size: int = 224, grayscale: bool = False):
        self.image_size = image_size
        self.grayscale = grayscale

    def __call__(self, img: Image.Image) -> np.ndarray:
        return to_normalized_array(resize(img, self.image_size), self.grayscale)

    def base_view(self, img: Image.Image) -> np.ndarray:
        """The deterministic uint8 stage before normalization — what the
        device-resident cache stores (data/device_cache.py); normalize then
        runs on device and matches ``to_normalized_array`` to float rounding."""
        img = resize(img, self.image_size)
        if self.grayscale:
            img = img.convert("L")
        return np.asarray(img.convert("RGB"), np.uint8)
