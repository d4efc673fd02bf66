"""K1: the fused prototype head (1x1 add-on conv -> per-node softmax per
patch -> spatial max-pool), and K1b, its adjoint, as hand-written CUDA
kernels for Hopper.

K1 replaces ``pipnet_tpu/ops/pallas_head.py::_head_kernel`` (reached from
``fused_head_forward``); its kernel is ``csrc/fused_head.cu``.  K1b replaces
the analytic softmax / max-pool adjoint of ``make_fused_head``
(``pallas_head.py:436-448``, XLA in the JAX package); its kernel is
``csrc/head_backward.cu``.  Both are built for ``sm_90a`` at first use
(``ops/build.py``) and bound with ``ctypes``.

What bounds K1 on an H100, at the flagship serving shape (B=8, 26x26
patches, D=768, P=3840, bf16): the product, 2*8*676*768*3840 = 32 GFLOP,
about 32 us at the 989 TFLOP/s bf16 dense peak; the memory it must move is
about 56 MB (F 8.3 MB + K 5.9 MB + pf 41.5 MB bf16), about 17 us at
3.35 TB/s.  The first design is right and simple: one block per
(node-aligned 128-column group, image) loops over the patch rows, so the
max-pool needs no atomics, and its row tiles are shared-memory products
(SIMT FMA in f32, ``mma.sync`` in bf16).  It leaves ``wgmma``/TMA, a
``cp.async`` pipeline, and reuse of the F and K tiles across row tiles to
later work.  One launch covers every bucket of the tree.  K1b is bound by
bytes (it reads pf and g_pf and writes dz); see its source.

``fused_head`` runs the kernel for CUDA tensors and the plain PyTorch
version ``fused_head_reference`` for CPU tensors; there is no fallback from
one to the other.  When autograd records, it goes through ``FusedHead``,
whose backward is K1b (``head_backward``; plain version
``head_backward_reference``) followed by ``dF = dz K^T`` and ``dK = F^T dz``
as matrix products, as the JAX package leaves them to XLA.
``fused_head.launches`` and ``head_backward.launches`` count kernel
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..tree.compile import TreeArrays
from .build import check_cuda, kernel_entry
from .segment import _node_onehot, segment_softmax, segment_sum_to_nodes, tree_tensor

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


def check_head_inputs(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
                      what: str = "fused head") -> None:
    """Raise unless features (B, H, W, D) and kernel (D, P) are what the head
    kernels take: P the tree's padded width, one device, float32 or
    bfloat16 in both, contiguous."""
    if features.dim() != 4 or kernel.dim() != 2:
        raise ValueError(f"expected features (B,H,W,D) and kernel (D,P), got "
                         f"{tuple(features.shape)} and {tuple(kernel.shape)}")
    D, P = features.shape[-1], tree.num_protos_padded
    if tuple(kernel.shape) != (D, P):
        raise ValueError(f"kernel shape {tuple(kernel.shape)} != ({D}, {P})")
    if kernel.device != features.device:
        raise ValueError(f"features on {features.device}, kernel on {kernel.device}")
    if features.dtype not in _DTYPE_CODES or kernel.dtype != features.dtype:
        raise TypeError(f"{what} takes float32 or bfloat16 features and a "
                        f"kernel of the same dtype, got {features.dtype} and "
                        f"{kernel.dtype}")
    if not (features.is_contiguous() and kernel.is_contiguous()):
        raise ValueError(f"{what} needs contiguous features and kernel")


def _launch(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
            tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    check_head_inputs(features, kernel, tree)
    B, H, W, D = features.shape
    P = tree.num_protos_padded
    dev = features.device
    groups = tree_tensor(tree, "fused_head_groups", column_groups(tree), dev,
                         torch.int32)
    valid = tree_tensor(tree, "proto_valid_u8", tree.proto_valid, dev, torch.uint8)
    pf = torch.empty((B, H, W, P), dtype=features.dtype, device=dev)
    pooled = torch.empty((B, P), dtype=torch.float32, device=dev)
    lib, fn = kernel_entry("fused_head", "pipnet_fused_head_forward",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            features.data_ptr(), kernel.data_ptr(), valid.data_ptr(),
            groups.data_ptr(), pf.data_ptr(), pooled.data_ptr(),
            B, H * W, D, P, groups.shape[0], float(tau),
            _DTYPE_CODES[features.dtype], stream)
    check_cuda(lib, code, "fused head launch")
    fused_head.launches += 1
    return pf, pooled


def _forward(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
             tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    if features.device.type == "cpu":
        return fused_head_reference(features, kernel, tree, tau)
    if features.device.type != "cuda":
        raise ValueError(f"fused head runs on cuda or cpu, not {features.device}")
    return _launch(features, kernel, tree, tau)


def fused_head(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
               tau: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused conv + per-node softmax + max-pool (the contract of the JAX
    package's ``fused_head_forward``; differentiable, as its
    ``make_fused_head``).

    features (B, H, W, D), kernel (D, P) -> (pf (B, H, W, P) in the input
    dtype, pooled (B, P) f32).  CUDA tensors go through the kernel (or
    raise); CPU tensors through ``fused_head_reference``.  Without autograd
    recording (``no_grad``, ``inference_mode``) it is one forward and
    nothing else."""
    if torch.is_grad_enabled() and (features.requires_grad or kernel.requires_grad):
        return FusedHead.apply(features, kernel, tree, tau)
    return _forward(features, kernel, tree, tau)


fused_head.launches = 0


# ---------------------------------------------------------------------------
# K1b: the adjoint
# ---------------------------------------------------------------------------

def head_backward_reference(pf: torch.Tensor, g_pf: Optional[torch.Tensor],
                            g_pooled: torch.Tensor, tree: TreeArrays,
                            tau: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version of K1b, in f32 with dz cast to pf's dtype.

    The pooled cotangent goes to every spatial position equal to the max of
    pf (taken again from pf itself: bf16 pf never equals the f32 pooled
    output), split evenly between ties; then the per-node softmax adjoint
    ``dz = pf * (g_tot - bcast_n(sum_{p in n} g_tot * pf)) / tau``.
    ``g_pf`` None means zero."""
    p = pf.float()
    is_max = p == p.amax(dim=(1, 2), keepdim=True)
    counts = is_max.sum(dim=(1, 2), keepdim=True).clamp(min=1)
    g = is_max / counts * g_pooled.float()[:, None, None, :]
    if g_pf is not None:
        g = g + g_pf.float()
    onehot = tree_tensor(tree, "node_onehot", _node_onehot(tree), p.device, torch.float32)
    inner = segment_sum_to_nodes(g * p, tree) @ onehot.T
    return (p * (g - inner) * (1.0 / tau)).to(pf.dtype)


def _check_backward(pf, g_pf, g_pooled, tree):
    if pf.dim() != 4 or pf.shape[-1] != tree.num_protos_padded:
        raise ValueError(f"pf shape {tuple(pf.shape)} is not (B, H, W, "
                         f"{tree.num_protos_padded})")
    if pf.dtype not in _DTYPE_CODES:
        raise TypeError(f"head backward takes float32 or bfloat16 pf, got {pf.dtype}")
    if g_pf is not None and (g_pf.shape != pf.shape or g_pf.dtype != pf.dtype):
        raise TypeError(f"g_pf {tuple(g_pf.shape)} {g_pf.dtype} does not match pf "
                        f"{tuple(pf.shape)} {pf.dtype}")
    if tuple(g_pooled.shape) != (pf.shape[0], pf.shape[-1]) or g_pooled.dtype != torch.float32:
        raise TypeError(f"g_pooled must be ({pf.shape[0]}, {pf.shape[-1]}) float32, got "
                        f"{tuple(g_pooled.shape)} {g_pooled.dtype}")
    for t in (g_pf, g_pooled):
        if t is not None and t.device != pf.device:
            raise ValueError(f"pf on {pf.device}, a cotangent on {t.device}")
    if not all(t.is_contiguous() for t in (pf, g_pf, g_pooled) if t is not None):
        raise ValueError("head backward needs contiguous pf and cotangents")


def _launch_backward(pf, g_pf, g_pooled, tree, tau):
    B, H, W, P = pf.shape
    groups = tree_tensor(tree, "fused_head_groups", column_groups(tree), pf.device,
                         torch.int32)
    dz = torch.empty_like(pf)
    lib, fn = kernel_entry("head_backward", "pipnet_head_backward",
                           [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(pf.device):
        stream = torch.cuda.current_stream(pf.device).cuda_stream
        code = fn(pf.data_ptr(), None if g_pf is None else g_pf.data_ptr(),
                  g_pooled.data_ptr(), groups.data_ptr(), dz.data_ptr(),
                  B, H * W, P, groups.shape[0], float(tau), _DTYPE_CODES[pf.dtype], stream)
    check_cuda(lib, code, "head backward launch")
    head_backward.launches += 1
    return dz


def head_backward(pf: torch.Tensor, g_pf: Optional[torch.Tensor],
                  g_pooled: torch.Tensor, tree: TreeArrays,
                  tau: float = 1.0) -> torch.Tensor:
    """K1b: dz (B, H, W, P) in pf's dtype from pf, its cotangent ``g_pf``
    (None: zero) and the f32 pooled cotangent ``g_pooled`` (B, P).  CUDA
    tensors go through the kernel (or raise); CPU tensors through
    ``head_backward_reference``."""
    _check_backward(pf, g_pf, g_pooled, tree)
    if pf.device.type == "cpu":
        return head_backward_reference(pf, g_pf, g_pooled, tree, tau)
    if pf.device.type != "cuda":
        raise ValueError(f"head backward runs on cuda or cpu, not {pf.device}")
    return _launch_backward(pf, g_pf, g_pooled, tree, tau)


head_backward.launches = 0


def projection_grads(features: torch.Tensor, kernel: torch.Tensor, dz: torch.Tensor,
                     needs: Tuple[bool, bool]):
    """``(dF, dK) = (dz K^T, F^T dz)`` for z = F K, each only where
    ``needs`` asks for it; plain matrix products, as the JAX package leaves
    them to XLA."""
    D, P = kernel.shape
    dz2 = dz.reshape(-1, P)
    dF = (dz2 @ kernel.T).reshape(features.shape) if needs[0] else None
    dK = features.reshape(-1, D).T @ dz2 if needs[1] else None
    return dF, dK


class FusedHead(torch.autograd.Function):
    """``(features, kernel) -> (pf, pooled)`` through K1, with K1b and the two
    projection products as its backward (the JAX package's
    ``make_fused_head``).  The residuals are the inputs and pf."""

    @staticmethod
    def forward(ctx, features, kernel, tree, tau):
        pf, pooled = _forward(features, kernel, tree, tau)
        ctx.save_for_backward(features, kernel, pf)
        ctx.tree, ctx.tau = tree, tau
        ctx.set_materialize_grads(False)
        return pf, pooled

    @staticmethod
    def backward(ctx, g_pf, g_pooled):
        features, kernel, pf = ctx.saved_tensors
        if g_pooled is None:
            g_pooled = torch.zeros(pf.shape[0], pf.shape[-1], device=pf.device)
        dz = head_backward(pf, None if g_pf is None else g_pf.contiguous(),
                           g_pooled.float().contiguous(), ctx.tree, ctx.tau)
        return (*projection_grads(features, kernel, dz, ctx.needs_input_grad[:2]),
                None, None)
