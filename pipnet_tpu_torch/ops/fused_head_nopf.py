"""K2: the no-pf fused prototype head, as a hand-written CUDA kernel for
Hopper.

Replaces ``pipnet_tpu/ops/pallas_head.py::_head_nopf_kernel`` (reached from
``fused_head_nopf_forward``); the kernel is ``csrc/fused_head_nopf.cu``,
built for ``sm_90a`` at first use (``ops/build.py``) and bound with
``ctypes``.  For features holding two views stacked, (2B, H, W, D), it gives
both views' pooled maxima and align_pf's per-node patch reduction

    logsum[b, n] = sum_hw log(sum_{p in n} pf[b, hw, p] * pf[B + b, hw, p] + eps)

without writing the (2B, H, W, P) softmaxed maps to device memory.

What bounds it on an H100 at the flagship train step (64 image pairs, 26x26
patches, D=768, 3780 real prototype columns): the two views' products,
502 GFLOP, 0.51 ms at the 989 TFLOP/s bf16 dense peak and 7.5 ms at the
67 TFLOP/s f32 rate; the bytes (bf16: F 133 MB, K 5.9 MB, outputs 2 MB)
take 0.04 ms.  The bf16 kernel is K1's Hopper core (``csrc/head_tile.cuh``)
over (column group, image pair) items: each K tile serves both views, the
softmaxes and the per-node inner products run on the accumulator registers,
and the per-node log sums are added in row order.  As for K1 the epilogue,
not overlapped with the products, holds it above its bound.  The f32 kernel
runs on the SIMT product tile of K1 and K4 (``csrc/simt_tile.cuh``): one
block per (column group, row tile of ``F32_PAIR_ROWS`` of the B * H * W
pair rows), whose 128 product rows are those pair rows of view 1 over the
same rows of view 2, so each K slice is loaded once for both views; the
column maxima meet in pooled by ``atomicMax``, and each image's per-node
log sums are kept per row tile (``partial``) and added in row-tile order by
the image's last tile to finish (``count``), in the same launch; it runs at
about half its f32 bound, the SIMT product's rate (``PERF.md``).  Either
way logsum does not depend on the run, and a tree of whole nodes takes one
launch a call.

A node wider than the column tile (flat PIP-Net) is cut into parts
(``fused_head.split_plan``) and takes three launches: both views' row
statistics per part, the node-wide softmax with each row's inner product
per part, and the per-node log sums over the parts.  In f32 the first
stores its tiles' z in a scratch that the second reads back
(``nopf_scratch_shapes``), in place of a second product.

``fused_head_nopf`` runs the kernel for CUDA tensors and the plain PyTorch
version ``fused_head_nopf_reference`` for CPU tensors, with no fallback
between them; ``fused_head_nopf.launches`` counts kernel launches.  When
autograd records it goes through ``FusedHeadNoPF``, whose backward
recomputes both views' pf with one K1 launch, builds pf's cotangent from
logsum's (each view gets half of the inner product's, the symmetrised
stop-gradient of align_pf), and runs K1b and the two projection products.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..tree.compile import TreeArrays
from .build import check_cuda, kernel_entry
from .fused_head import (_DTYPE_CODES, F32_ROW_TILE, SIMT_TILE_COLS, _forward, _ptr, _rows,
                         check_head_inputs, head_backward, head_plan, plan_launches,
                         projection_grads)
from .segment import _node_onehot, segment_softmax, segment_sum_to_nodes, tree_tensor


def fused_head_nopf_reference(features: torch.Tensor, kernel: torch.Tensor,
                              tree: TreeArrays, tau: float = 1.0, eps: float = 1e-12
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, in f32 throughout: features (2B, H, W, D),
    kernel (D, P) -> (pooled (2B, P) f32, logsum (B, N) f32)."""
    B = features.shape[0] // 2
    p = segment_softmax(features.float() @ kernel.float(), tree, tau=tau)
    ip = segment_sum_to_nodes(p[:B] * p[B:], tree)
    return p.amax(dim=(1, 2)), torch.log(ip + eps).sum(dim=(1, 2))


# the f32 kernel's row tile: F32_PAIR_ROWS pair rows of view 1 over the same
# rows of view 2 fill the 128 rows of the SIMT product (PAIR_ROWS in
# csrc/fused_head_nopf.cu)
F32_PAIR_ROWS = F32_ROW_TILE // 2


def nopf_scratch_shapes(pairs: int, hw: int, nodes: int, whole_groups: int, parts: int,
                        dtype: torch.dtype) -> dict:
    """The scratch of one K2 call in ``dtype`` on ``pairs`` image pairs of
    ``hw`` patch rows, for a tree of ``nodes`` nodes and a plan of
    ``whole_groups`` groups of whole nodes and ``parts`` parts of wide
    nodes: name -> shape, None where the call needs none.

    For the parts: ``stats`` each view-image row's (max, sum) a part, ``ip``
    each pair row's inner product over a part, and in f32 ``z``, each (row
    tile, part)'s 128 x 128 z tile, which the statistics launch stores and
    the normalising launch reads back.  For the whole-node groups in f32:
    ``partial``, the per-node log sums of each run of a row tile's rows in
    one image (the run of tile t in image b at row t + b: distinct for
    distinct runs), and ``count`` (int32), each (group, image)'s finished
    row tiles."""
    f32 = dtype == torch.float32
    tiles = -(-pairs * hw // F32_PAIR_ROWS)
    return {"stats": (2 * pairs * hw, parts, 2) if parts else None,
            "ip": (pairs * hw, parts) if parts else None,
            "z": (tiles, parts, F32_ROW_TILE, SIMT_TILE_COLS) if f32 and parts else None,
            "partial": (tiles + pairs - 1, nodes) if f32 and whole_groups else None,
            "count": (whole_groups, pairs) if f32 and whole_groups else None}


def _check(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays) -> None:
    check_head_inputs(features, kernel, tree, "no-pf head", aligned_f32=True)
    if features.shape[0] % 2:
        raise ValueError(f"features {tuple(features.shape)} do not hold two stacked "
                         f"views (an even batch)")


def _launch(features, kernel, tree, tau, eps):
    B2, H, W, D = features.shape
    P, N = tree.num_protos_padded, tree.num_nodes
    dev = features.device
    whole, wide = head_plan(tree, features.dtype, dev)
    valid = tree_tensor(tree, "proto_valid_u8", tree.proto_valid, dev, torch.uint8)
    proto_node = tree_tensor(tree, "proto_node_i32", tree.proto_node, dev, torch.int32)
    pooled = torch.empty((B2, P), dtype=torch.float32, device=dev)
    logsum = torch.empty((B2 // 2, N), dtype=torch.float32, device=dev)
    scratch = {name: None if shape is None else torch.empty(
                   shape, dtype=torch.int32 if name == "count" else torch.float32, device=dev)
               for name, shape in nopf_scratch_shapes(B2 // 2, H * W, N, _rows(whole),
                                                      _rows(wide), features.dtype).items()}
    lib, fn = kernel_entry("fused_head_nopf", "pipnet_fused_head_nopf_forward",
                           [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(features.data_ptr(), kernel.data_ptr(), valid.data_ptr(),
                  _ptr(whole), _rows(whole), _ptr(wide), _rows(wide), proto_node.data_ptr(),
                  *[_ptr(scratch[k]) for k in ("stats", "ip", "z", "partial", "count")],
                  pooled.data_ptr(), logsum.data_ptr(),
                  B2 // 2, H * W, D, P, N, float(tau), float(eps),
                  _DTYPE_CODES[features.dtype], stream)
    check_cuda(lib, code, "no-pf head launch")
    fused_head_nopf.launches += plan_launches(whole, wide, 3)
    return pooled, logsum


def _nopf_forward(features, kernel, tree, tau, eps):
    _check(features, kernel, tree)
    if features.device.type == "cpu":
        return fused_head_nopf_reference(features, kernel, tree, tau, eps)
    if features.device.type != "cuda":
        raise ValueError(f"no-pf head runs on cuda or cpu, not {features.device}")
    return _launch(features, kernel, tree, tau, eps)


def fused_head_nopf(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
                    tau: float = 1.0, eps: float = 1e-12
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Both views' pooled maxima and align_pf's per-node log-reduction (the
    contract of the JAX package's ``fused_head_nopf_forward``; differentiable,
    as its ``make_fused_head_nopf``).

    features (2B, H, W, D), kernel (D, P) -> (pooled (2B, P) f32, logsum
    (B, N) f32).  CUDA tensors go through the kernel (or raise); CPU tensors
    through ``fused_head_nopf_reference``."""
    if torch.is_grad_enabled() and (features.requires_grad or kernel.requires_grad):
        return FusedHeadNoPF.apply(features, kernel, tree, tau, eps)
    return _nopf_forward(features, kernel, tree, tau, eps)


fused_head_nopf.launches = 0


class FusedHeadNoPF(torch.autograd.Function):
    """``(features, kernel) -> (pooled, logsum)`` through K2.  Its backward
    recomputes pf for both views with one K1 launch (the forward stored
    nothing but its inputs), forms pf's cotangent from logsum's, and runs
    K1b and the projection products (``make_fused_head_nopf``'s VJP,
    ``pallas_head.py:350-383``)."""

    @staticmethod
    def forward(ctx, features, kernel, tree, tau, eps):
        pooled, logsum = _nopf_forward(features, kernel, tree, tau, eps)
        ctx.save_for_backward(features, kernel)
        ctx.tree, ctx.tau, ctx.eps = tree, tau, eps
        ctx.set_materialize_grads(False)
        return pooled, logsum

    @staticmethod
    def backward(ctx, g_pooled, g_logsum):
        features, kernel = ctx.saved_tensors
        tree = ctx.tree
        pf, _ = _forward(features, kernel, tree, ctx.tau)
        g_pf = None
        if g_logsum is not None:
            # d/dpf of sum log(ip + eps) under align_pf's symmetrised
            # stop-gradient 0.5 * (pf1 sg(pf2) + sg(pf1) pf2): each view
            # gets half of the inner product's cotangent times the other view
            B = pf.shape[0] // 2
            p = pf.float()
            onehot = tree_tensor(tree, "node_onehot", _node_onehot(tree), p.device,
                                 torch.float32)
            ip = segment_sum_to_nodes(p[:B] * p[B:], tree)
            gseg = (g_logsum.float()[:, None, None, :] / (ip + ctx.eps)) @ onehot.T
            g_pf = (0.5 * gseg.repeat(2, 1, 1, 1) * torch.cat([p[B:], p[:B]])).to(pf.dtype)
        if g_pooled is None:
            g_pooled = torch.zeros(pf.shape[0], pf.shape[-1], device=pf.device)
        dz = head_backward(pf, g_pf, g_pooled.float().contiguous(), tree, ctx.tau)
        return (*projection_grads(features, kernel, dz, ctx.needs_input_grad[:2]),
                None, None, None)
