"""Heatmap overlays and prototype patch galleries.

The port's copy of the JAX package's ``interp/heatmaps.py`` (counterpart of
the rendering in ``util/vis_pipnet.py:120-241``, ``util/vis_hpipnet.py:306-389``
and ``util/visualize_prediction.py``): JET colormap overlays of per-prototype
activation maps, cropped argmax patches with bounding boxes, and grid
montages, with the same roundings (``(a*255).astype(uint8)``, PIL bicubic,
the 0.7/0.3 blend truncated to uint8).

The port does not depend on matplotlib: ``JET_LUT`` is matplotlib's 256-entry
``jet`` table, built from its segment data (``matplotlib._cm._jet_data``)
the way ``LinearSegmentedColormap`` builds it, and ``jet`` indexes it the
way a ``Colormap`` indexes floats (``x*N``, ``x == 1`` mapped to ``N-1``,
truncated), so ``jet(x)`` equals ``matplotlib.cm.jet(x)``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageDraw

IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)

# matplotlib's jet: (x, y0, y1) rows per channel
_JET_SEGMENTS = {
    "red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
    "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
              (1.0, 0, 0)),
    "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0)),
}
JET_N = 256


def _lookup_table(n: int, segments) -> np.ndarray:
    """``n`` samples of a piecewise-linear channel: linear interpolation
    between the (x, y0, y1) rows at ``(n-1) * linspace(0, 1, n)``."""
    data = np.asarray(segments, np.float64)
    x, y0, y1 = data[:, 0] * (n - 1), data[:, 1], data[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1],
                          [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


JET_LUT = np.stack([_lookup_table(JET_N, _JET_SEGMENTS[c]) for c in ("red", "green", "blue")]
                   + [np.ones(JET_N)], axis=1)                         # (256, 4) f64


def jet(x: np.ndarray) -> np.ndarray:
    """RGBA float64 (..., 4) of floats ``x`` in [0, 1] (below 0: the first
    entry; above 1: the last)."""
    xa = np.array(x, dtype=np.result_type(x, np.float32), copy=True)
    xa *= JET_N
    xa[xa == JET_N] = JET_N - 1
    return JET_LUT.take(np.clip(xa, 0, JET_N - 1).astype(int), axis=0)


def denormalize(x: np.ndarray) -> np.ndarray:
    """Normalized HWC float -> uint8 RGB."""
    img = (x * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def jet_heatmap(activation: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Min-max normalized activation -> JET-colored uint8 RGB at ``size``."""
    a = activation.astype(np.float32)
    a = (a - a.min()) / (a.max() - a.min() + 1e-8)
    a = np.asarray(Image.fromarray((a * 255).astype(np.uint8)).resize(
        size, Image.BICUBIC), np.float32) / 255.0
    rgba = jet(a)
    return (rgba[..., :3] * 255).astype(np.uint8)


def overlay_heatmap(img_uint8: np.ndarray, activation: np.ndarray,
                    alpha: float = 0.3) -> np.ndarray:
    """0.7*img + 0.3*jet(activation) blend (ref vis_hpipnet.py:134-153)."""
    hm = jet_heatmap(activation, (img_uint8.shape[1], img_uint8.shape[0]))
    return np.clip((1 - alpha) * img_uint8 + alpha * hm, 0, 255).astype(np.uint8)


def draw_patch_box(img: Image.Image, box: Tuple[int, int, int, int],
                   color=(255, 255, 0), width: int = 2) -> Image.Image:
    h0, h1, w0, w1 = box
    d = ImageDraw.Draw(img)
    d.rectangle([w0, h0, w1 - 1, h1 - 1], outline=color, width=width)
    return img


def crop_patch(img_uint8: np.ndarray, box: Tuple[int, int, int, int]) -> np.ndarray:
    h0, h1, w0, w1 = box
    return img_uint8[h0:h1, w0:w1]


def save_image_grid(images: Sequence[np.ndarray], path: str,
                    cols: Optional[int] = None, pad: int = 2,
                    labels: Optional[Sequence[str]] = None) -> str:
    """Montage of equally-sized uint8 images."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not images:
        return path
    h, w = images[0].shape[:2]
    n = len(images)
    cols = cols or n
    rows = -(-n // cols)
    canvas = np.full(((h + pad) * rows - pad, (w + pad) * cols - pad, 3), 255,
                     np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * (h + pad): r * (h + pad) + h,
               c * (w + pad): c * (w + pad) + w] = im
    out = Image.fromarray(canvas)
    if labels:
        d = ImageDraw.Draw(out)
        for i, lab in enumerate(labels[:n]):
            r, c = divmod(i, cols)
            d.text((c * (w + pad) + 2, r * (h + pad) + 2), lab, fill=(255, 0, 0))
    out.save(path)
    return path


def save_topk_gallery(proj, topk: dict, out_dir: str, *, prefix: str = "prototype",
                      with_heatmap: bool = False,
                      proto_features: Optional[np.ndarray] = None) -> List[str]:
    """Per-prototype top-k patch grids (``visualize_topk`` second pass,
    util/vis_pipnet.py:120-241).  Loads images from proj.paths, crops the
    argmax patch of each top-k image."""
    os.makedirs(out_dir, exist_ok=True)
    written = []
    for p, entries in topk.items():
        if not entries:
            continue
        patches = []
        for img_idx, score in entries:
            if score <= 0.1:
                continue
            with Image.open(proj.paths[img_idx]) as im:
                im = im.convert("RGB").resize((proj.image_size, proj.image_size),
                                              Image.BILINEAR)
            arr = np.asarray(im, np.uint8)
            box = proj.patch_box(img_idx, p)
            patches.append(crop_patch(arr, box))
        if patches:
            written.append(save_image_grid(
                patches, os.path.join(out_dir, f"{prefix}_{p}.png")))
    return written
