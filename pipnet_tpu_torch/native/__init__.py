"""Native (C++) host preprocessing, loaded with ctypes.

The port's copy of the JAX package's normalizer (``preprocess.cc``: uint8
HWC -> ImageNet-normalized float32 HWC in one pass, and the fused bilinear
resize + crop + flip + normalize).  ``g++`` compiles it at first use into
``native/libpipnet_native-<hash>.so`` under the build root
(``paths.build_root``: ``build/`` in a checkout, listed in ``.gitignore``;
the user's cache for an installed package); the hash covers the source
and the flags, so an edited source builds anew and nothing is written
beside the source.
Importing this module compiles nothing.  There is no fallback: a failed
build raises with the compiler's output.

Flags: ``-O3 -ffp-contract=off`` and no ``-march=native``, so the library
runs on any x86-64 host and gives the same bits on every one (no fused
multiply-adds).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ..paths import build_root

SOURCE = Path(__file__).resolve().parent / "preprocess.cc"
BUILD_DIR = build_root() / "native"
CXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

IMAGENET_MEAN = np.asarray((0.485, 0.456, 0.406), np.float32)
IMAGENET_STD = np.asarray((0.229, 0.224, 0.225), np.float32)


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libpipnet_native-{digest[:12]}.so"


def build() -> Path:
    """Compile ``preprocess.cc`` unless this source and these flags are
    built already; raises with the compiler's output on a failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native normalizer needs a C++ compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)            # atomic: a reader never sees a partial .so
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The built library with its entry points' argument types declared."""
    so = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.resize_crop_normalize.argtypes = [p, i, i, i, i, i, i, i, i, i, p, p, p]
    so.resize_crop_normalize.restype = None
    so.normalize_u8.argtypes = [p, i, i, p, p, p]
    so.normalize_u8.restype = None
    return so


def _check_u8(img_u8: np.ndarray) -> np.ndarray:
    if img_u8.dtype != np.uint8 or img_u8.ndim != 3 or img_u8.shape[2] != 3:
        raise ValueError(f"expected a (H, W, 3) uint8 image, got {img_u8.dtype} "
                         f"{img_u8.shape}")
    return np.ascontiguousarray(img_u8)


def _check_out(out: Optional[np.ndarray], shape: Tuple[int, ...]) -> np.ndarray:
    if out is None:
        return np.empty(shape, np.float32)
    if out.shape != shape or out.dtype != np.float32 or not out.flags.c_contiguous:
        raise ValueError(f"out must be a C-contiguous float32 array of shape {shape}")
    return out


def normalize_u8(img_u8: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 HWC -> (x / 255 - mean) / std as float32 HWC (the C++ multiplies
    by 1/255 and by 1/std)."""
    img_u8 = _check_u8(img_u8)
    h, w = img_u8.shape[:2]
    out = _check_out(out, (h, w, 3))
    lib().normalize_u8(img_u8.ctypes.data, h, w, IMAGENET_MEAN.ctypes.data,
                       IMAGENET_STD.ctypes.data, out.ctypes.data)
    return out


def resize_crop_normalize(img_u8: np.ndarray, resize_to: int, crop_yx: tuple,
                          crop_hw: tuple, hflip: bool,
                          out: Optional[np.ndarray] = None) -> np.ndarray:
    """uint8 HWC -> bilinear resize to ``resize_to``² (half-pixel centres,
    2 taps) -> crop -> optional horizontal flip -> normalized float32 HWC,
    in one pass."""
    img_u8 = _check_u8(img_u8)
    ch, cw = crop_hw
    out = _check_out(out, (ch, cw, 3))
    lib().resize_crop_normalize(
        img_u8.ctypes.data, img_u8.shape[0], img_u8.shape[1], resize_to, resize_to,
        crop_yx[0], crop_yx[1], ch, cw, int(hflip), IMAGENET_MEAN.ctypes.data,
        IMAGENET_STD.ctypes.data, out.ctypes.data)
    return out
