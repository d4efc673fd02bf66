"""Device-side photometric augmentation (transform2 on the card).

The port of the JAX package's ``ops/device_augment.py``.  The train step
takes ONE shared geometric view per sample (uint8, or the float output of
``device_geometric.transform1_batch``, both on the uint8 lattice) and
derives the two photometric views, their random crops and the ImageNet
normalization on the device.

Every op reproduces PIL's algorithm, including its uint8 rounding of the
degenerate image and of the blend, so the augmentation space matches the
reference (PIL parity of each op is held in the JAX package's
``tests/test_device_augment.py``; the port is held to the JAX functions).

Op algorithms (PIL sources):
* Brightness/Color/Contrast/Sharpness — ``ImageEnhance``: degenerate image
  (black / L-gray / mean-gray / SMOOTH-filtered) blended with the original:
  ``out = degenerate + factor * (img - degenerate)``, rounded, clipped.
* Posterize — keep the top ``bits`` bits (``ImageOps.posterize``).
* AutoContrast — per-channel remap [min, max] -> [0, 255] with PIL's
  truncating LUT (``ImageOps.autocontrast`` at cutoff=0).
* Equalize — PIL's integer histogram equalization per image and channel:
  a histogram by a scatter-add, the LUT by PIL's step rule, applied by one
  gather.

Sampling is separate from application: ``sample_view`` draws a
``ViewDraws`` (op, magnitude, crop offsets) from a ``torch.Generator``, and
``two_view_transform2`` applies given draws.  TrivialAugment picks one op
per image; ``_apply_ops`` applies each op only to the images that
drew it (the batch's op counts are read on the host: one synchronisation
for both views of ``two_view_transform2``, or none when the caller read
them with the draws), which gives the same pixels as computing every op on
the whole batch and selecting, with a ninth of the work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.augment import IMAGENET_MEAN, IMAGENET_STD, NUM_BINS, _space_no_shape
from ..device import host_to_device

# ITU-R 601-2 luma, PIL's exact integer coefficients (convert("L")):
# L = (R*19595 + G*38470 + B*7471 + 0x8000) >> 16
_L_R, _L_G, _L_B = 19595.0, 38470.0, 7471.0
# ImageEnhance.Sharpness's SMOOTH kernel as f32 values
_SMOOTH = np.asarray([[1, 1, 1], [1, 5, 1], [1, 1, 1]], np.float32) / np.float32(13.0)


def _pil_gray(x: torch.Tensor) -> torch.Tensor:
    """PIL convert('L') with its integer rounding; x float in [0, 255],
    (..., 3) -> (..., 1).  Every partial sum is an integer below 2^24, so
    exact in f32."""
    lum = x[..., 0] * _L_R + x[..., 1] * _L_G + x[..., 2] * _L_B + 32768.0
    return torch.floor(lum / 65536.0)[..., None]


def _u8(x: torch.Tensor) -> torch.Tensor:
    """Round-half-up to the uint8 lattice (PIL blend / filter rounding),
    staying in float."""
    return torch.floor(x + 0.5).clamp(0.0, 255.0)


def _blend(degenerate: torch.Tensor, img: torch.Tensor, factor) -> torch.Tensor:
    return _u8(degenerate + factor * (img - degenerate))


def brightness(x, factor):
    return _blend(torch.zeros_like(x), x, factor)


def color(x, factor):
    return _blend(_pil_gray(x).expand_as(x), x, factor)


def contrast(x, factor):
    # PIL: mean = int(ImageStat.Stat(image.convert("L")).mean[0] + 0.5)
    mean = torch.floor(_pil_gray(x).mean(dim=(-3, -2, -1), keepdim=True) + 0.5)
    return _blend(mean.expand_as(x), x, factor)


def sharpness(x, factor):
    """ImageEnhance.Sharpness: degenerate = SMOOTH filter
    ([1,1,1;1,5,1;1,1,1]/13), border pixels left unfiltered.  x (..., H, W, C)."""
    h, w = x.shape[-3], x.shape[-2]
    rows = torch.arange(-1, h + 1, device=x.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=x.device).clamp(0, w - 1)
    xp = x.index_select(-3, rows).index_select(-2, cols)          # edge padding
    sm = torch.zeros_like(x)
    for dy in range(3):
        for dx in range(3):
            sm = sm + float(_SMOOTH[dy, dx]) * xp[..., dy:dy + h, dx:dx + w, :]
    sm = _u8(sm)
    # PIL leaves the 1-px border equal to the source
    ii = torch.arange(h, device=x.device)[:, None, None]
    jj = torch.arange(w, device=x.device)[None, :, None]
    interior = (ii > 0) & (ii < h - 1) & (jj > 0) & (jj < w - 1)
    return _blend(torch.where(interior, sm, x), x, factor)


def posterize(x, bits):
    shift = 8 - torch.as_tensor(bits, device=x.device)
    return ((x.int() >> shift) << shift).to(x.dtype)


def autocontrast(x, _=None):
    lo = x.amin(dim=(-3, -2), keepdim=True)
    hi = x.amax(dim=(-3, -2), keepdim=True)
    scale = 255.0 / (hi - lo).clamp(min=1.0)
    # PIL builds the LUT with int() truncation: int(ix*scale + offset)
    out = torch.floor((x - lo) * scale + 1e-5)
    return torch.where(hi > lo, out.clamp(0.0, 255.0), x)


def _counts(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``bincount(keys, minlength=n)`` for keys below n, by a scatter-add:
    ``bincount`` on a card reads the largest key on the host first, which
    synchronizes the stream."""
    return torch.zeros(n, dtype=torch.long, device=keys.device).scatter_add_(
        0, keys.long(), torch.ones_like(keys, dtype=torch.long))


def equalize_batch(x: torch.Tensor) -> torch.Tensor:
    """PIL ImageOps.equalize over a batch (B, H, W, 3), per image and
    channel: step = (npixels - count(last nonzero bin)) // 255;
    lut[i] = (step // 2 + cumsum_excl(h)[i]) // step, clipped; identity
    if step == 0 or the channel has one level.  Integer arithmetic, as PIL's."""
    B = x.shape[0]
    v = x.reshape(B, -1, 3).long()
    # one histogram row per (image, channel): slot (b*3 + c)*256 + level
    key = v + 256 * torch.arange(B * 3, device=x.device).view(B, 1, 3)
    h = _counts(key.reshape(-1), B * 3 * 256).view(B, 3, 256)
    nz = h > 0
    last_idx = 255 - nz.flip(2).int().argmax(dim=2, keepdim=True)
    last_cnt = h.gather(2, last_idx)
    step = (h.sum(dim=2, keepdim=True) - last_cnt) // 255                  # (B, 3, 1)
    csum = h.cumsum(dim=2) - h                                              # exclusive
    lut = ((step // 2 + csum) // step.clamp(min=1)).clamp(0, 255)
    ident = (step[..., 0] <= 0) | (nz.sum(dim=2) <= 1)                      # (B, 3)
    mapped = lut.reshape(-1)[key].to(x.dtype).view_as(x)
    return torch.where(ident[:, None, None, :], x, mapped)


# ---------------------------------------------------------------------------
# TrivialAugment over a batch
# ---------------------------------------------------------------------------

def _space_tables(cars: bool) -> Tuple[List[str], np.ndarray, np.ndarray]:
    """(op names, bins (n_ops, NUM_BINS), signed (n_ops,)) from the host-side
    space definitions (``data/augment.py``), the single source of truth.  The
    CARS space (``cars``), which no cell draws from, is not held."""
    if cars:
        raise ValueError("the reference does not hold the CARS augmentation space")
    space = _space_no_shape()
    names = list(space.keys())
    bins = np.zeros((len(names), NUM_BINS), np.float32)
    signed = np.zeros(len(names), bool)
    for i, n in enumerate(names):
        _, b, s = space[n]
        bins[i, :len(b)] = b
        if len(b) == 1:
            bins[i, :] = b[0]
        signed[i] = s
    return names, bins, signed


def sample_photometric(batch: int, generator: torch.Generator, cars: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """TrivialAugment sampling (one op, one of 31 bins, sign flip w.p. 0.5
    for signed ops; ``data/augment.py:TrivialAugment.__call__``) for a batch:
    (op index (B,) int64, magnitude (B,) f32)."""
    names, bins, signed = _space_tables(cars)
    dev = generator.device
    op = torch.randint(0, len(names), (batch,), generator=generator, device=dev)
    bin_ = torch.randint(0, NUM_BINS, (batch,), generator=generator, device=dev)
    mag = host_to_device(bins, dev)[op, bin_]
    flip = torch.rand(batch, generator=generator, device=dev) < 0.5
    return op, torch.where(host_to_device(signed, dev)[op] & flip, -mag, mag)


def _apply_op(name: str, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Op ``name`` on images x (n, H, W, 3) with magnitudes m (n, 1, 1, 1)."""
    if name == "Brightness":
        return brightness(x, 1.0 + m)
    if name == "Color":
        return color(x, 1.0 + m)
    if name == "Contrast":
        return contrast(x, 1.0 + m)
    if name == "Sharpness":
        return sharpness(x, 1.0 + m)
    if name == "Posterize":
        return posterize(x, m.int().clamp(0, 8))
    if name == "AutoContrast":
        return autocontrast(x)
    if name == "Equalize":
        return equalize_batch(x)
    raise ValueError(f"unknown photometric op {name!r}")


def _apply_ops(x: torch.Tensor, op: torch.Tensor, mag: torch.Tensor, counts: List[int],
               cars: bool) -> torch.Tensor:
    """TrivialAugment, op ``op[i]`` at magnitude ``mag[i]`` on image i of a
    batch (B, H, W, 3) on the uint8 lattice, given the batch's op counts on
    the host; returns float32 on the lattice.  Each op runs once, on the
    images that drew it."""
    names, _, _ = _space_tables(cars)
    x = x.float()
    order = torch.argsort(op, stable=True)
    out = x.clone()
    start = 0
    for name, n in zip(names, counts):
        idx = order[start:start + n]
        start += n
        if n and name != "Identity":
            out[idx] = _apply_op(name, x[idx], mag[idx].view(-1, 1, 1, 1))
    return out


def random_crop_batch(x: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                      out_size: int) -> torch.Tensor:
    """Per-image crop (B, S, S, C) -> (B, out, out, C) at offsets (y0, x0)
    (transform2's RandomCrop, util/data.py:787)."""
    B, S = x.shape[0], x.shape[1]
    if S == out_size:
        return x
    r = torch.arange(out_size, device=x.device)
    rows = (y0[:, None] + r)[:, :, None]
    cols = (x0[:, None] + r)[:, None, :]
    return x[torch.arange(B, device=x.device)[:, None, None], rows, cols]


def normalize(x: torch.Tensor) -> torch.Tensor:
    """[0, 255] -> ImageNet-normalized, f32."""
    mean = host_to_device(np.asarray(IMAGENET_MEAN, np.float32) * np.float32(255.0), x.device)
    std = host_to_device(np.asarray(IMAGENET_STD, np.float32) * np.float32(255.0), x.device)
    return (x - mean) / std


@dataclass
class ViewDraws:
    """One photometric view's draws for a batch, each (B,) on one device:
    the TA op index and magnitude, and the random crop's offsets."""
    op: torch.Tensor
    mag: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor


def sample_view(batch: int, size: int, out_size: int, generator: torch.Generator,
                cars: bool = False) -> ViewDraws:
    """One view's draws for ``batch`` shared views of ``size``^2 cropped to
    ``out_size``^2."""
    op, mag = sample_photometric(batch, generator, cars)
    y, x = (torch.randint(0, size - out_size + 1, (batch,), generator=generator,
                          device=generator.device) for _ in range(2))
    return ViewDraws(op, mag, y, x)


def op_counts(draws: Sequence[ViewDraws], cars: bool = False) -> torch.Tensor:
    """Each view's op counts (n_views, n_ops), on the draws' device."""
    n_ops = len(_space_tables(cars)[0])
    return torch.stack([_counts(d.op, n_ops) for d in draws])


def two_view_transform2(x: torch.Tensor, image_size: int, draws: Sequence[ViewDraws], *,
                        cars: bool = False, counts: Optional[List[List[int]]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Device transform2 for both views from one shared geometric view, a
    view per entry of ``draws``: TrivialAugment (photometric) ->
    RandomCrop(image_size) -> normalize (ref TwoAugSupervisedDataset,
    util/data.py:895-898).  ``counts``: the views' op counts on the host
    (``op_counts``); without them they are read here, one synchronisation."""
    if counts is None:
        counts = op_counts(draws, cars).tolist()
    v1, v2 = (normalize(random_crop_batch(_apply_ops(x, d.op, d.mag, c, cars), d.y, d.x,
                                          image_size))
              for d, c in zip(draws, counts))
    return v1, v2
