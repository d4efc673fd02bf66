"""K1: the fused prototype head (1x1 add-on conv -> per-node softmax per
patch -> spatial max-pool), and K1b, its adjoint, as hand-written CUDA
kernels for Hopper.

K1 replaces ``pipnet_tpu/ops/pallas_head.py::_head_kernel`` (reached from
``fused_head_forward``); its kernel is ``csrc/fused_head.cu``.  K1b replaces
the analytic softmax / max-pool adjoint of ``make_fused_head``
(``pallas_head.py:436-448``, XLA in the JAX package); its kernel is
``csrc/head_backward.cu``.  Both are built for ``sm_90a`` at first use
(``ops/build.py``) and bound with ``ctypes``.

What bounds K1 on an H100: its product.  At the flagship training shape
(B=128, 26x26 patches, D=768, 3780 real columns, bf16) it is 502 GFLOP,
0.51 ms at the 989 TFLOP/s bf16 dense peak, against 0.21 ms for its bytes
(F 133 MB, K 5.9 MB, pf 664 MB at 3.35 TB/s); at serving (B=8) 32 GFLOP,
32 us.  The bf16 kernel is built for Hopper (``csrc/head_tile.cuh``): a
persistent block per SM, TMA tile loads into a ring of shared-memory stages,
``wgmma`` products of 128 rows by two 128-column groups, and the per-node
softmax, column max and pf stores on the accumulator registers; the
epilogue, which does not overlap the product, is what holds it above its
bound (``PERF.md``).  In f32 the product runs on the SIMT FMA units (TF32
would miss 1e-5; 31.4 GFLOP at serving, 0.47 ms at 67 TFLOP/s): one block
per (column group, row tile of ``F32_ROW_TILE`` of the B * H * W patch
rows) runs the register-tiled, ``cp.async``-pipelined product it shares
with K4 (``csrc/simt_tile.cuh``), the per-node softmax on a shared-memory z
tile, and meets the other row tiles' column max by an ``atomicMax`` on
pooled, one for each image the tile's rows hold.  Each kernel plans its
own column groups (``column_groups``, ``head_plan``): whole nodes of one
bucket, so a node's softmax never crosses groups.  One launch covers every
bucket of the tree.  K1b is bound by bytes (it reads pf and g_pf and
writes dz): it plans its own groups (``backward_plan``: whole nodes in a window of 16-byte
vectors, ending on 32-byte sectors where they can), keeps a block's pf slice
in shared memory so pf is read once, and moves g_pf and dz as 16-byte
vectors; see its source.

A node wider than a kernel's tile (flat PIP-Net: one node of 768
prototypes) is cut into parts, groups of its consecutive columns
(``column_groups``, ``plan_parts``).  The kernels launch the parts apart
from the whole-node groups (``split_plan``): K1 twice, once for each row's
max and sum over each part and once for the node-wide softmax from those,
its column max and pf; K1b twice, once for each row's sum of g_tot * pf
over each part and once for dz.  A tree without such a node takes one
launch of each kernel, over whole nodes.

``fused_head`` runs the kernel for CUDA tensors and the plain PyTorch
version ``fused_head_reference`` for CPU tensors; there is no fallback from
one to the other.  When autograd records, it goes through ``FusedHead``,
whose backward is K1b (``head_backward``; plain version
``head_backward_reference``) followed by ``dF = dz K^T`` and ``dK = F^T dz``
as matrix products, as the JAX package leaves them to XLA.
``fused_head.launches`` and ``head_backward.launches`` count kernel
launches (``plan_launches``: two more for a tree with a wide node).
"""

from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..tree.compile import TreeArrays
from .build import check_cuda, kernel_entry
from .segment import _node_onehot, segment_softmax, segment_sum_to_nodes, tree_tensor

# column plans: the f32 tile of K1 and K2 (TN in head_tile.cuh, BN in
# simt_tile.cuh), which K1 loads from a multiple of 4 columns (16-byte
# cp.async), and the bf16 kernels' tile of one column group (HALF in
# head_tile.cuh; K1 runs two groups side by side in one wgmma of 256
# columns, K2 one group per view), which TMA starts on a multiple of 8
# columns (16 bytes); a bf16 group holds at most MAX_GROUP_NODES nodes
# (NMAX, the size of the kernels' per-node tables).  K1's f32 kernel takes
# row tiles of F32_ROW_TILE of the B * H * W patch rows (BM in simt_tile.cuh).
SIMT_TILE_COLS = 128
SIMT_ALIGN_COLS = 4
F32_ROW_TILE = 128
BF16_TILE_COLS = 128
MAX_GROUP_NODES = 16
TMA_ALIGN_COLS = 8
# K1b reads and writes 16-byte vectors, one thread each, at most a warp's
# 32 of them a row; a block's pf slice takes at most BACKWARD_SLICE_BYTES,
# so that two share an SM's 227 KB; a group ends on a 32-byte sector of dz
# where it can (SECTOR_BYTES)
BACKWARD_VECTOR_BYTES = 16
BACKWARD_MAX_VECTORS = 32
BACKWARD_SLICE_BYTES = 110 * 1024
SECTOR_BYTES = 32
# the kernels' group record (csrc/head_tile.cuh GF): col_start, ncols,
# width, node_off, part, parts (``plan_parts``)
GROUP_FIELDS = 6
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _node_parts(start: int, width: int, tile_cols: int, align: int, sector: int) -> list:
    """The parts of the node at columns ``[start, start + width)``: runs of
    its columns, each fitting ``tile_cols - c0 % align`` columns from its
    start ``c0`` and, where that leaves room, ending on a multiple of
    ``sector`` columns.  One part (the whole node) when it fits."""
    parts, a, end = [], start, start + width
    while a < end:
        b = min(end, a + tile_cols - a % align)
        if b < end and b - b % sector > a:
            b -= b % sector
        parts.append((a, b - a, width))
        a = b
    return parts


def column_groups(tree: TreeArrays, tile_cols: int, max_nodes: Optional[int] = None,
                  align: int = 1, sector: int = 1) -> np.ndarray:
    """(G, 3) int32 (col_start, ncols, width) per column group of a kernel
    whose column tile is ``tile_cols`` wide.

    Each bucket is cut into runs of whole nodes (at most ``max_nodes``), so a
    node's softmax never crosses groups; the padded tail beyond the last
    bucket becomes groups of width 0, which write zeros.  A kernel whose
    tile must start at a multiple of ``align`` columns (the bf16 kernels'
    TMA loads: 8 columns, 16 bytes) holds a group starting at ``c0`` from
    tile column ``c0 % align`` on, so the group fits ``tile_cols - c0 %
    align`` columns.  With ``sector`` (columns) a group that could hold
    more nodes than fill a whole number of sectors holds such a multiple, so
    that groups of a bucket starting on a sector also end on one.

    A bucket whose nodes do not fit the tile from every start (``width >
    tile_cols - (align - 1)``) is cut node by node into parts
    (``_node_parts``): groups of fewer than ``width`` consecutive columns of
    one node, in order, whose per-node statistics the kernels merge across
    groups (``plan_parts``)."""
    groups = []
    covered = 0
    for b in tree.buckets:
        covered = b.proto_offset + b.num_nodes * b.width
        if b.width > tile_cols - (align - 1):
            for n in range(b.num_nodes):
                groups += _node_parts(b.proto_offset + n * b.width, b.width, tile_cols,
                                      align, sector)
            continue
        first = 0
        while first < b.num_nodes:
            start = b.proto_offset + first * b.width
            n = min((tile_cols - start % align) // b.width, b.num_nodes - first)
            if max_nodes is not None:
                n = min(n, max_nodes)
            whole = sector // math.gcd(b.width, sector)     # nodes a whole sector run takes
            if n > whole:
                n -= n % whole
            groups.append((start, n * b.width, b.width))
            first += n
    for start in range(covered, tree.num_protos_padded, tile_cols):
        groups.append((start, min(tile_cols, tree.num_protos_padded - start), 0))
    return np.asarray(groups, np.int32).reshape(-1, 3)


def plan_parts(groups: np.ndarray) -> np.ndarray:
    """(G, GROUP_FIELDS) int32: each group of ``column_groups`` with
    (node_off, part, parts): the column of its node at which the group
    starts, its index among its node's parts, and how many parts the node
    has.  A group of whole nodes and the padded tail are (0, 0, 1)."""
    out = np.zeros((len(groups), GROUP_FIELDS), np.int32)
    out[:, :3] = groups
    out[:, 5] = 1
    i = 0
    while i < len(groups):
        width = int(groups[i, 2])
        if width == 0 or groups[i, 1] >= width:
            i += 1
            continue
        j, off = i, 0
        while off < width:                   # the node's parts, in order
            out[j, 3:5] = (off, j - i)
            off += int(groups[j, 1])
            j += 1
        out[i:j, 5] = j - i
        i = j
    return out


def split_plan(groups: np.ndarray, device: torch.device
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """A column plan (``column_groups``) as the kernels launch it: ``(whole,
    wide)``, each a (G, GROUP_FIELDS) int32 table on ``device`` or None.
    ``whole`` holds the groups of whole nodes, ``wide`` the parts of nodes
    wider than the tile (launched twice: the per-part row statistics, then
    the pass that normalises by the merged node statistics); the padded tail
    goes with ``whole`` unless only parts exist."""
    plan = plan_parts(groups)
    part = plan[:, 5] > 1
    tail = plan[:, 2] == 0
    whole = ~part & ~tail
    if whole.any() or not part.any():
        whole = whole | tail
    else:
        part = part | tail
    return tuple(torch.as_tensor(plan[rows], device=device) if rows.any() else None
                 for rows in (whole, part))


def _cached_plan(tree: TreeArrays, key: tuple, device: torch.device, make: Callable):
    """``make()``, cached on the tree per ``(key, device)``: the head
    kernels' plans are made once per tree, kernel, dtype and device."""
    cache = tree.__dict__.setdefault("_head_plan_cache", {})
    key = key + (str(device),)
    if key not in cache:
        # normal tensors even when first asked for under inference_mode
        with torch.inference_mode(False):
            cache[key] = make()
    return cache[key]


def plan_launches(whole: Optional[torch.Tensor], wide: Optional[torch.Tensor],
                  wide_launches: int) -> int:
    """Kernel launches of one call on a split plan: one over the whole-node
    groups, ``wide_launches`` over the parts of wide nodes."""
    return (whole is not None) + (wide_launches if wide is not None else 0)


def _head_tile(dtype: torch.dtype) -> Tuple[int, Optional[int], int]:
    """(tile_cols, max_nodes, align) of the head kernels' column plan in
    ``dtype``: the SIMT tile for f32, tiles on 4-column boundaries; for bf16
    the 128-column tile, at most MAX_GROUP_NODES nodes a group, tiles on
    8-column boundaries."""
    if dtype == torch.float32:
        return SIMT_TILE_COLS, None, SIMT_ALIGN_COLS
    return BF16_TILE_COLS, MAX_GROUP_NODES, TMA_ALIGN_COLS


def head_plan(tree: TreeArrays, dtype: torch.dtype, device: torch.device
              ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The ``(whole, wide)`` plan (``split_plan``) K1 and K2 launch on for
    ``dtype`` (``_head_tile``), cached on the tree."""
    tile = _head_tile(dtype)
    return _cached_plan(tree, ("head",) + tile, device,
                        lambda: split_plan(column_groups(tree, *tile), device))


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
                      what: str = "fused head", aligned_f32: bool = False) -> None:
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
    if features.device.type == "cuda" and (features.dtype == torch.bfloat16 or aligned_f32):
        # the bf16 kernels read both by TMA, K1's f32 kernel by 16-byte
        # cp.async: row strides and base addresses must be multiples of 16 bytes
        vec = 16 // features.element_size()
        if D % vec or P % vec or features.data_ptr() % 16 or kernel.data_ptr() % 16:
            raise ValueError(f"{what} on the card needs D and P multiples of {vec} and "
                             f"16-byte aligned {features.dtype} features and kernel, got "
                             f"D={D}, P={P}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _rows(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.shape[0]


def _launch(features: torch.Tensor, kernel: torch.Tensor, tree: TreeArrays,
            tau: float) -> Tuple[torch.Tensor, torch.Tensor]:
    check_head_inputs(features, kernel, tree, aligned_f32=True)
    B, H, W, D = features.shape
    P = tree.num_protos_padded
    dev = features.device
    whole, wide = head_plan(tree, features.dtype, dev)
    valid = tree_tensor(tree, "proto_valid_u8", tree.proto_valid, dev, torch.uint8)
    pf = torch.empty((B, H, W, P), dtype=features.dtype, device=dev)
    pooled = torch.empty((B, P), dtype=torch.float32, device=dev)
    # each row's (max, sum) over each part of a wide node
    stats = (torch.empty((B * H * W, wide.shape[0], 2), dtype=torch.float32, device=dev)
             if wide is not None else None)
    lib, fn = kernel_entry("fused_head", "pipnet_fused_head_forward",
                           [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(
            features.data_ptr(), kernel.data_ptr(), valid.data_ptr(),
            _ptr(whole), _rows(whole), _ptr(wide), _rows(wide), _ptr(stats),
            pf.data_ptr(), pooled.data_ptr(), B, H * W, D, P, float(tau),
            _DTYPE_CODES[features.dtype], stream)
    check_cuda(lib, code, "fused head launch")
    fused_head.launches += plan_launches(whole, wide, 2)
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


def _backward_groups(tree: TreeArrays, dtype: torch.dtype, hw: int
                     ) -> Tuple[int, int, np.ndarray]:
    """K1b's (sv, tile columns, (G, 3) ``column_groups`` plan) for ``hw``
    patch rows (``backward_plan``)."""
    es = torch.tensor([], dtype=dtype).element_size()
    vec = BACKWARD_VECTOR_BYTES // es
    window = BACKWARD_MAX_VECTORS * vec
    needs = [-(-(b.width + vec - 1) // vec) * vec for b in tree.buckets]
    need = max((n for n in needs if n <= window), default=vec)
    budget = BACKWARD_SLICE_BYTES // (hw * es) // vec * vec
    tile = min(max(budget, need), window)
    plan = column_groups(tree, tile, None, vec, sector=SECTOR_BYTES // es)
    nodes = plan[plan[:, 2] > 0]
    span = int(max((c0 % vec + n for c0, n, _ in nodes), default=vec))
    return -(-span // vec), tile, plan


def backward_plan(tree: TreeArrays, dtype: torch.dtype, hw: int, device: torch.device
                  ) -> Tuple[int, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """K1b's plan for ``hw`` patch rows in ``dtype``: ``(sv, whole, wide)``,
    cached on the tree.

    Groups are whole nodes of one bucket, at most as many columns as two
    blocks' pf slices (``hw`` rows, ``BACKWARD_SLICE_BYTES`` each) leave
    room for, whole 32-byte sectors of nodes where they fit (no sector of
    dz is written by two blocks; ``column_groups``' ``sector``), each seen
    from the 16-byte boundary at or below its start; a node wider than that
    tile (or than the window of ``BACKWARD_MAX_VECTORS`` vectors) is cut
    into parts of it, ending on sectors.  ``sv`` is the most 16-byte
    vectors a group so seen needs (a row's lanes in the kernel, and the
    slice's row); ``whole`` and ``wide`` are the plan as ``split_plan``
    gives it."""
    def make():
        sv, _, groups = _backward_groups(tree, dtype, hw)
        return (sv, *split_plan(groups, device))
    return _cached_plan(tree, ("backward", str(dtype), hw), device, make)


def _launch_backward(pf, g_pf, g_pooled, tree, tau):
    B, H, W, P = pf.shape
    vec = BACKWARD_VECTOR_BYTES // pf.element_size()
    if P % vec or any(t.data_ptr() % BACKWARD_VECTOR_BYTES
                      for t in (pf, g_pf) if t is not None):
        raise ValueError(f"head backward on the card reads 16-byte vectors: it needs P a "
                         f"multiple of {vec} and 16-byte aligned pf and g_pf, got P={P}")
    sv, whole, wide = backward_plan(tree, pf.dtype, H * W, pf.device)
    dz = torch.empty_like(pf)
    # each row's sum of g_tot * pf over each part of a wide node
    inner = (torch.empty((B * H * W, wide.shape[0]), dtype=torch.float32, device=pf.device)
             if wide is not None else None)
    lib, fn = kernel_entry("head_backward", "pipnet_head_backward",
                           [ctypes.c_void_p] * 3 + [ctypes.c_void_p, ctypes.c_int] * 2
                           + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(pf.device):
        stream = torch.cuda.current_stream(pf.device).cuda_stream
        code = fn(pf.data_ptr(), _ptr(g_pf), g_pooled.data_ptr(),
                  _ptr(whole), _rows(whole), _ptr(wide), _rows(wide), _ptr(inner),
                  dz.data_ptr(), B, H * W, P, sv, float(tau), _DTYPE_CODES[pf.dtype], stream)
    check_cuda(lib, code, "head backward launch")
    head_backward.launches += plan_launches(whole, wide, 2)
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
