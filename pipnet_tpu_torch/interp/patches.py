"""Latent-patch <-> pixel geometry (the port's copy of the JAX package's
``interp/patches.py``).

Reproduces the reference patch contract exactly so interpretability outputs
are comparable: patch size 32 px, skip = round((image_size-32)/(wshape-1))
(``util/func.py:3-6``), with the 26x26 special case that shifts interior
patches by +4 px (``util/vis_pipnet.py:373-411``)."""

from __future__ import annotations

from typing import Tuple


def get_patch_size(image_size: int, wshape: int) -> Tuple[int, int]:
    patchsize = 32
    skip = round((image_size - patchsize) / (wshape - 1))
    return patchsize, skip


def get_img_coordinates(img_size: int, latent_hw: Tuple[int, int],
                        patchsize: int, skip: int,
                        h_idx: int, w_idx: int) -> Tuple[int, int, int, int]:
    """Pixel box (h_min, h_max, w_min, w_max) of a latent location."""
    H, W = latent_hw
    if H == 26 and W == 26:
        h_min = max(0, (h_idx - 1) * skip + 4)
        if h_idx >= W - 1:
            h_min -= 4
        h_max = h_min + patchsize
        w_min = max(0, (w_idx - 1) * skip + 4)
        if w_idx >= W - 1:
            w_min -= 4
        w_max = w_min + patchsize
    else:
        h_min = h_idx * skip
        h_max = min(img_size, h_idx * skip + patchsize)
        w_min = w_idx * skip
        w_max = min(img_size, w_idx * skip + patchsize)

    if h_idx == H - 1:
        h_max = img_size
    if w_idx == W - 1:
        w_max = img_size
    if h_max == img_size:
        h_min = img_size - patchsize
    if w_max == img_size:
        w_min = img_size - patchsize
    return h_min, h_max, w_min, w_max
