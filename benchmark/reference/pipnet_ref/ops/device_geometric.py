"""Device-side geometric augmentation (transform1 on the card).

The port of the JAX package's ``ops/device_geometric.py``.  The loader ships
the cached resized base image (``image_size + 8``^2 uint8; ``+ 32`` for
pretraining) and the train step applies

    TrivialAugment-NoColor (nearest affine) -> HFlip -> RandomResizedCrop

to the whole batch on the device (the counterpart of the host chain
``data/augment.py:TwoViewTransform.transform1``, itself the rebuild of the
reference recipe at ``util/data.py:768-809``).

Sampling is separate from application: ``sample_transform1`` draws a
``GeometricDraws`` from a ``torch.Generator`` (on the batch's device), and
``transform1_batch`` applies given draws, so a test can hand the port the
JAX package's own draws.

* The nearest affine warp (TA's shear / translate / rotate, torchvision
  ``F.affine`` matrix semantics reproduced from ``data/augment.py:_affine``)
  is one gather over the batch.  Its coefficients are computed in float64
  and rounded to float32 once, so the card and the CPU sample the same
  pixels.
* RandomResizedCrop + flip are axis-aligned, so PIL's bilinear resample is
  separable: two batched products with dense PIL-style triangle-filter
  weight matrices (B, out, S).  As in the JAX function the weights and the
  row pass are rounded to ``dtype`` (bf16 by default); the products run in
  float64, where every product of two such values and their few-term sums
  are exact, so the result does not depend on the summation order: the
  card and the CPU agree bit for bit, and both agree with PIL within one
  grey level.
* The RRC box search (10 tries of area / log-ratio sampling with a
  centre-crop fallback, torchvision semantics) is vectorized: all 10
  candidates are drawn up front and the first valid one is selected.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch

from ..data.augment import NUM_BINS
from ..device import host_to_device

# TA-NoColor magnitude tables (data/augment.py:_space_no_color; ref
# util/data.py:904-913), in a fixed order: the affine parameters are
# computed per op below
GEO_NAMES = ("Identity", "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate")
_GEO_MAX = {"ShearX": 0.5, "ShearY": 0.5, "TranslateX": 16.0, "TranslateY": 16.0,
            "Rotate": 60.0}


def _geo_bins() -> np.ndarray:
    bins = np.zeros((len(GEO_NAMES), NUM_BINS), np.float32)
    for i, n in enumerate(GEO_NAMES):
        if n in _GEO_MAX:
            bins[i] = np.linspace(0.0, _GEO_MAX[n], NUM_BINS)
    return bins


@dataclass
class GeometricDraws:
    """transform1's random draws for a batch, each (B,) on one device: the
    TA op index and its signed magnitude, the RRC box (x, y, cw, ch) and
    the horizontal flip."""
    op: torch.Tensor
    mag: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    cw: torch.Tensor
    ch: torch.Tensor
    flip: torch.Tensor


def sample_geometric(batch: int, generator: torch.Generator
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One uniformly-chosen geometric op at a uniformly-chosen signed
    strength per image (TrivialAugment semantics): (op (B,) int64,
    magnitude (B,) f32)."""
    dev = generator.device
    op = torch.randint(0, len(GEO_NAMES), (batch,), generator=generator, device=dev)
    bin_ = torch.randint(0, NUM_BINS, (batch,), generator=generator, device=dev)
    mag = host_to_device(_geo_bins(), dev)[op, bin_]
    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    signed = host_to_device([n in _GEO_MAX for n in GEO_NAMES], dev)
    return op, torch.where(signed[op] & flip, -mag, mag)


def ta_affine_coeffs(op: torch.Tensor, mag: torch.Tensor, size: int) -> Sequence[torch.Tensor]:
    """Per-image inverse affine (output -> input) coefficients m0..m5, each
    (B,) f32, for the selected TA op, reproducing ``data/augment.py:_affine``
    (torchvision F.affine matrix about the image centre, inverted for PIL's
    output->input convention).  Computed in float64, rounded once."""
    cx = cy = size * 0.5
    m, op = mag.double(), op.long()
    zero = torch.zeros_like(m)
    # each image's op sets one of (rotation, shear x, shear y, translation
    # x, translation y) from its magnitude and leaves the others 0: shear
    # magnitudes go through degrees(atan(mag)) and back to radians
    rot = torch.where(op == GEO_NAMES.index("Rotate"), m * (math.pi / 180.0), zero)
    sx = torch.where(op == GEO_NAMES.index("ShearX"), torch.atan(m), zero)
    sy = torch.where(op == GEO_NAMES.index("ShearY"), torch.atan(m), zero)
    tx = torch.where(op == GEO_NAMES.index("TranslateX"), torch.round(m), zero)
    ty = torch.where(op == GEO_NAMES.index("TranslateY"), torch.round(m), zero)
    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    m2 = cx - ia * (cx + tx) - ib * (cy + ty)
    m5 = cy - ic * (cx + tx) - id_ * (cy + ty)
    return [v.float() for v in (ia, ib, m2, ic, id_, m5)]


def nearest_affine_warp(x_u8: torch.Tensor, m: Sequence[torch.Tensor]) -> torch.Tensor:
    """PIL ``transform(..., AFFINE, resample=NEAREST)`` over a batch (B, H, W, C):
    out[y, x] = in[floor(m3(x+.5) + m4(y+.5) + m5), floor(m0(x+.5) + m1(y+.5) + m2)],
    0 (black) outside the image: PIL samples at output pixel centres and
    truncates.  One gather over the flattened image."""
    B, H, W, C = x_u8.shape
    m0, m1, m2, m3, m4, m5 = (v.float()[:, None, None] for v in m)
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=x_u8.device),
                            torch.arange(W, dtype=torch.float32, device=x_u8.device),
                            indexing="ij")
    xin = m0 * (xs + 0.5) + m1 * (ys + 0.5) + m2
    yin = m3 * (xs + 0.5) + m4 * (ys + 0.5) + m5
    # TA magnitudes are rationals (k/60 shears), so sample positions land
    # EXACTLY on integer boundaries for whole columns and rows.  The +1e-4
    # bias (far above f32 rounding at coordinates <= 256, far below any
    # non-boundary fraction in the tables) makes those boundary pixels floor
    # to the boundary index whatever the rounding.  PIL's own NEAREST affine
    # quantizes the coefficients to 16.16 fixed point, so on exact-boundary
    # columns PIL may sample the adjacent source pixel; boundary-free draws
    # match PIL exactly.
    ix = torch.floor(xin + 1e-4).long()
    iy = torch.floor(yin + 1e-4).long()
    inside = (ix >= 0) & (ix < W) & (iy >= 0) & (iy < H)
    idx = (iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1)).reshape(B, H * W, 1)
    out = torch.gather(x_u8.reshape(B, H * W, C), 1, idx.expand(B, H * W, C))
    return out.masked_fill(~inside.reshape(B, H * W, 1), 0).reshape(B, H, W, C)


def rrc_box(area_scale: torch.Tensor, log_ratio: torch.Tensor, ux: torch.Tensor,
            uy: torch.Tensor, size: int) -> Tuple[torch.Tensor, ...]:
    """torchvision RandomResizedCrop's box on a ``size``^2 image from its
    uniform draws: ``area_scale`` and ``log_ratio`` (B, 10), one per try, in
    [scale) and [log ratio); ``ux``, ``uy`` (B,) in [0, 1).  The first valid
    try wins; with none, the centre crop (``data/augment.py:random_resized_crop``).
    Returns integer (x, y, cw, ch), each (B,)."""
    target = float(size * size) * area_scale
    ar = torch.exp(log_ratio)
    cw = torch.round(torch.sqrt(target * ar)).long()
    ch = torch.round(torch.sqrt(target / ar)).long()
    valid = (cw > 0) & (cw <= size) & (ch > 0) & (ch <= size)
    first = valid.int().argmax(dim=1, keepdim=True)     # the first True
    any_valid = valid.any(dim=1)
    # a square input with ratio in [3/4, 4/3] always admits the full image
    cw = torch.where(any_valid, cw.gather(1, first)[:, 0], size)
    ch = torch.where(any_valid, ch.gather(1, first)[:, 0], size)
    x = torch.floor(ux * (size - cw + 1).float()).long()
    y = torch.floor(uy * (size - ch + 1).float()).long()
    x = torch.where(any_valid, x, (size - cw) // 2)
    y = torch.where(any_valid, y, (size - ch) // 2)
    return x, y, cw, ch


def sample_rrc_box(batch: int, size: int, generator: torch.Generator
                   ) -> Tuple[torch.Tensor, ...]:
    """``rrc_box`` on draws from ``generator``: area scale in [0.95, 1),
    aspect ratio in [3/4, 4/3) on the log scale (transform1's
    RandomResizedCrop, ``data/augment.py:random_resized_crop``)."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    area_scale = uniform((batch, 10), 0.95, 1.0)
    log_ratio = uniform((batch, 10), math.log(3 / 4), math.log(4 / 3))
    ux, uy = uniform((batch,), 0.0, 1.0), uniform((batch,), 0.0, 1.0)
    return rrc_box(area_scale, log_ratio, ux, uy, size)


def sample_transform1(batch: int, size: int, generator: torch.Generator) -> GeometricDraws:
    """transform1's draws for ``batch`` base images of ``size``^2."""
    op, mag = sample_geometric(batch, generator)
    flip = torch.rand(batch, generator=generator, device=generator.device) < 0.5
    x, y, cw, ch = sample_rrc_box(batch, size, generator)
    return GeometricDraws(op, mag, x, y, cw, ch, flip)


def _pil_triangle_weights(start: torch.Tensor, length: torch.Tensor, in_size: int,
                          out_size: int) -> torch.Tensor:
    """Dense per-image PIL-bilinear resampling weights (B, out_size, in_size),
    float64, for a 1-D resize of ``[start, start+length)`` -> ``out_size``.

    PIL (ImagingResampleHorizontal): scale = length/out, support =
    max(1, scale); centre = start + (xx+0.5)·scale; w(i) =
    triangle((i + 0.5 - centre)/max(1, scale)), taps clipped to the IMAGE
    (not the box) and normalized to sum 1."""
    f64 = dict(dtype=torch.float64, device=start.device)
    scale = length.double()[:, None, None] / float(out_size)
    ss = scale.clamp(min=1.0)
    xx = torch.arange(out_size, **f64)[None, :, None]
    centre = start.double()[:, None, None] + (xx + 0.5) * scale
    i = torch.arange(in_size, **f64)[None, None, :]
    w = (1.0 - ((i + 0.5 - centre) / ss).abs()).clamp(min=0.0)
    return w / w.sum(dim=2, keepdim=True).clamp(min=1e-12)


def _rounded(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to ``dtype`` through f32 (as the JAX function casts its
    f32 values), back in float64."""
    return x.float().to(dtype).double()


def rrc_flip_resize(x: torch.Tensor, box: Sequence[torch.Tensor], flip: torch.Tensor,
                    out_size: int, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """HFlip + RandomResizedCrop of ``box`` (x0, y0, cw, ch) to
    ``out_size``^2 as two batched products (separable PIL bilinear).
    x (B, S, S, C) on the uint8 lattice; returns float32 on the uint8
    lattice (PIL-rounded)."""
    B, S, _, C = x.shape
    x0, y0, cw, ch = box
    # fold hflip into the horizontal weights: flipping the image then
    # cropping [x0, x0+cw) samples the original at mirrored positions
    wx = _pil_triangle_weights(x0, cw, S, out_size)                      # (B, out, S)
    wx_f = _pil_triangle_weights(S - x0 - cw, cw, S, out_size).flip(1)
    wx = _rounded(torch.where(flip[:, None, None], wx_f, wx), dtype)
    wy = _rounded(_pil_triangle_weights(y0, ch, S, out_size), dtype)
    rows = torch.bmm(wy, _rounded(x, dtype).reshape(B, S, S * C))        # (B, out, S*C)
    rows = _rounded(rows, dtype).reshape(B, out_size, S, C)
    cols = torch.bmm(wx, rows.transpose(1, 2).reshape(B, S, out_size * C))
    z = cols.reshape(B, out_size, out_size, C).transpose(1, 2)
    return torch.floor(z + 0.5).clamp(0.0, 255.0).float().contiguous()


def transform1_batch(x_u8: torch.Tensor, draws: GeometricDraws, out_size: int,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The whole device transform1 on a batch of resized base images:
    TA-NoColor (nearest affine) -> HFlip -> RandomResizedCrop(out_size), with
    ``draws``.  Input (B, S, S, 3) uint8; output (B, out, out, 3) float32 on
    the uint8 lattice (what ``device_augment.two_view_transform2`` takes)."""
    m = ta_affine_coeffs(draws.op, draws.mag, x_u8.shape[1])
    warped = nearest_affine_warp(x_u8, m)
    return rrc_flip_resize(warped, (draws.x, draws.y, draws.cw, draws.ch), draws.flip,
                           out_size, dtype)
