"""K1: the fused prototype head (1x1 add-on conv -> per-node softmax per
patch -> spatial max-pool), as one hand-written CUDA kernel for Hopper.

Replaces ``pipnet_tpu/ops/pallas_head.py::_head_kernel`` (reached from
``fused_head_forward``); the kernel is ``csrc/fused_head.cu``, built for
``sm_90a`` at first use (``ops/build.py``) and bound with ``ctypes``.

What bounds it on an H100, at the flagship serving shape (B=8, 26x26
patches, D=768, P=3840, bf16): the product, 2*8*676*768*3840 = 32 GFLOP,
about 32 us at the 989 TFLOP/s bf16 dense peak; the memory it must move is
about 56 MB (F 8.3 MB + K 5.9 MB + pf 41.5 MB bf16), about 17 us at
3.35 TB/s.  The first design is right and simple: one block per
(node-aligned 128-column group, image) loops over the patch rows, so the
max-pool needs no atomics, and its row tiles are shared-memory products
(SIMT FMA in f32, ``mma.sync`` in bf16).  It leaves ``wgmma``/TMA, a
``cp.async`` pipeline, and reuse of the F and K tiles across row tiles to
later work.  One launch covers every bucket of the tree.

``fused_head`` runs the kernel for CUDA tensors and the plain PyTorch
version ``fused_head_reference`` for CPU tensors; there is no fallback from
one to the other.  ``fused_head.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from ..tree.compile import TreeArrays
from .build import check_cuda, load_library
from .segment import segment_softmax, tree_tensor

TILE_COLS = 128          # TN in csrc/fused_head.cu
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def column_groups(tree: TreeArrays) -> np.ndarray:
    """(G, 3) int32 (col_start, ncols, width) per kernel block column.

    Each bucket is cut into runs of whole nodes that fit ``TILE_COLS``
    columns, so a node's softmax never crosses blocks; the padded tail
    beyond the last bucket becomes groups of width 0, which write zeros."""
    groups = []
    covered = 0
    for b in tree.buckets:
        if b.width > TILE_COLS:
            raise ValueError(
                f"bucket width {b.width} exceeds the fused head kernel's "
                f"{TILE_COLS}-column tile; nodes that wide are not supported yet")
        per = TILE_COLS // b.width
        for first in range(0, b.num_nodes, per):
            n = min(per, b.num_nodes - first)
            groups.append((b.proto_offset + first * b.width, n * b.width, b.width))
        covered = b.proto_offset + b.num_nodes * b.width
    for start in range(covered, tree.num_protos_padded, TILE_COLS):
        groups.append((start, min(TILE_COLS, tree.num_protos_padded - start), 0))
    return np.asarray(groups, np.int32).reshape(-1, 3)


def fused_head_reference(features: torch.Tensor, kernel: torch.Tensor,
                         tree: TreeArrays, tau: float = 1.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K1: ``(F.float() @ K.float()) / tau``, the
    per-node softmax (``segment_softmax``), the spatial max in f32, and pf
    cast to the input dtype.  features (B, H, W, D), kernel (D, P) ->
    (pf (B, H, W, P), pooled (B, P) f32)."""
    z = features.float() @ kernel.float()
    p = segment_softmax(z, tree, tau=tau)
    return p.to(features.dtype), p.amax(dim=(1, 2))


def _launch(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
            tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if features.dim() != 4 or kernel.dim() != 2:
        raise ValueError(f"expected features (B,H,W,D) and kernel (D,P), got "
                         f"{tuple(features.shape)} and {tuple(kernel.shape)}")
    B, H, W, D = features.shape
    P = tree.num_protos_padded
    if tuple(kernel.shape) != (D, P):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != ({D}, {P})")
    if kernel.device != features.device:
        raise ValueError(f"features on {features.device}, kernel on {kernel.device}")
    if features.dtype not in _DTYPE_CODES or kernel.dtype != features.dtype:
        raise TypeError(f"fused head takes float32 or bfloat16 features and a "
                        f"kernel of the same dtype, got {features.dtype} and "
                        f"{kernel.dtype}")
    if not (features.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("fused head needs contiguous features and kernel")
    if torch.is_grad_enabled() and (features.requires_grad or kernel.requires_grad):
        raise NotImplementedError(
            "K1's backward is not ported yet (it comes with the training "
            "slice); call the fused head under torch.no_grad() or "
            "torch.inference_mode()")
    dev = features.device
    groups = tree_tensor(tree, "fused_head_groups", column_groups(tree), dev,
                         torch.int32)
    valid = tree_tensor(tree, "proto_valid_u8", tree.proto_valid, dev, torch.uint8)
    pf = torch.empty((B, H, W, P), dtype=features.dtype, device=dev)
    pooled = torch.empty((B, P), dtype=torch.float32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.pipnet_fused_head_forward(
            features.data_ptr(), kernel.data_ptr(), valid.data_ptr(),
            groups.data_ptr(), pf.data_ptr(), pooled.data_ptr(),
            B, H * W, D, P, groups.shape[0], float(tau),
            _DTYPE_CODES[features.dtype], stream)
    check_cuda(lib, code, "fused head launch")
    fused_head.launches += 1
    return pf, pooled


def _library() -> ctypes.CDLL:
    lib = load_library("fused_head")
    fn = lib.pipnet_fused_head_forward
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def fused_head(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
               tau: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused conv + per-node softmax + max-pool (the contract of the JAX
    package's ``fused_head_forward``).

    features (B, H, W, D), kernel (D, P) -> (pf (B, H, W, P) in the input
    dtype, pooled (B, P) f32).  CUDA tensors go through the kernel (or
    raise); CPU tensors through ``fused_head_reference``."""
    if features.device.type == "cpu":
        return fused_head_reference(features, kernel, tree, tau)
    if features.device.type != "cuda":
        raise ValueError(f"fused head runs on cuda or cpu, not {features.device}")
    return _launch(features, kernel, tree, tau)


fused_head.launches = 0
