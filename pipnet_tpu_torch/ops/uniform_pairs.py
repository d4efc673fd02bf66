"""K5 and K5b: the uniformity loss's pair sum and its gradient as
hand-written CUDA kernels for Hopper (``csrc/uniform_pairs.cu``, built for
``sm_90a`` at first use by ``ops/build.py`` and bound with ``ctypes``).

For the rows x (n, D) of one view, e_ij = exp(-t max(d2_ij, 0)) with d2_ij
= |x_i|^2 + |x_j|^2 - 2 x_i . x_j:

* ``uniform_pairs``: the sum over i < j of e_ij (K5), one f32 number
  (``launches`` counts K5's calls, one a call, which is three kernel
  launches: the row norms, the Gram tiles, the fixed-order sum);
* ``uniform_pairs_backward``: its gradient, scaled by the cotangent (K5b;
  ``launches`` counts K5b's calls, one a call, which is the row norms and
  two kernel launches for each chunk of ``chunk_rows`` rows);
* ``row_pairs``: a mesh rank's share (half the sum over j != i of its
  rows i) and the whole sum's gradient for its rows: one K5 call and one
  K5b call on the rank's row range.

No TPU kernel stands behind them: the JAX package computes the loss as a
``lax.scan`` over row blocks (``pipnet_tpu/losses/catalog.py::
uniform_loss``).  What bounds them on an H100 is their products: n^2 D for
K5's upper half of X X^T, 4 n^2 D for K5b's Gram and m X (14.4 TFLOP a
step at the flagship's 43,264 rows a view, D = 768: 14.6 ms at the 989
TFLOP/s bf16 peak).  The design keeps the (n x n) distances out of device
memory in K5 and passes only m, a chunk of rows at a time, through it in
K5b; see the source.

Dispatch, on what the code observes: CUDA rows take the kernels, bfloat16
(D a multiple of 8) on the TMA + ``wgmma`` tiles and float32 (D a multiple
of 4; the f32 configuration) on the SIMT tile that K1, K2 and K4 use in
f32; CUDA rows of another dtype raise.  CPU rows take the plain versions
below, the blocked PyTorch code the loss had before the kernels:
``pair_sum_reference`` and its recomputing backward
``pair_sum_backward_reference`` by blocks of ``block`` rows, and
``row_pairs_reference`` for a rank's rows; the kernels take no ``block``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .build import check_cuda, kernel_entry

UNIFORM_BLOCK = 2048
TILE = 128                 # rows of the kernels' tiles (csrc/uniform_pairs.cu)
GRAM_COLS = 256            # columns of a Gram tile (GRAM_BN there)
GROUP = 2048               # K5's tiles come in groups of GROUP rows x GROUP columns
MAX_CHUNK_ROWS = 4096      # K5b's scratch: at most this many rows of m


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _pair_d2(xr: torch.Tensor, x: torch.Tensor, sqr: torch.Tensor,
             sq: torch.Tensor) -> torch.Tensor:
    """Squared distances (b, m) of the rows ``xr`` to the rows ``x``, as
    ``|xr|^2 + |x|^2 - 2 xr x^T`` (products in the inputs' dtype, the rest
    in ``sq``'s: f32, or float64 for float64 inputs), unclamped; one new
    (b, m) tensor, the rest in place."""
    d2 = (xr @ x.T).to(sq.dtype).mul_(-2.0)
    return d2.add_(sqr[:, None]).add_(sq[None, :])


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def pair_sum_reference(x: torch.Tensor, t: float, block: int) -> torch.Tensor:
    """S(x) = sum over i < j of exp(-t max(d2_ij, 0)) for the rows of x, in
    f32 (float64 for float64 x), by row blocks."""
    n = x.shape[0]
    sq = (x.to(acc_dtype(x)) ** 2).sum(dim=-1)
    total = torch.zeros((), dtype=sq.dtype, device=x.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        # pairs i < j only: columns from the block's first row on
        e = _pair_d2(x[r0:r1], x[r0:], sq[r0:r1], sq[r0:]).clamp_(min=0.0)
        e.mul_(-t).exp_()
        total += e[:, r1 - r0:].sum() + torch.triu(e[:, :r1 - r0], diagonal=1).sum()
    return total


def pair_sum_backward_reference(x: torch.Tensor, g: torch.Tensor, t: float,
                                block: int) -> torch.Tensor:
    """g dS/dx, recomputing each block of distances; in x's dtype."""
    n = x.shape[0]
    sq = (x.to(acc_dtype(x)) ** 2).sum(dim=-1)
    dx = torch.empty(x.shape, dtype=sq.dtype, device=x.device)
    for r0 in range(0, n, block):
        r1 = min(r0 + block, n)
        d2 = _pair_d2(x[r0:r1], x, sq[r0:r1], sq)
        m = d2.clamp(min=0.0).mul_(-t).exp_()
        # max(d2, 0)'s derivative, split evenly at a tie as jnp.maximum's:
        # 1 where d2 > 0 (nearly every pair), 1/2 at 0, 0 below
        m.masked_fill_(d2 < 0, 0.0).masked_fill_(d2 == 0, 0.5)
        del d2
        m.mul_(-t * g)
        m[:, r0:r1].fill_diagonal_(0.0)
        # each pair (i, j) adds m_ij (2 x_i - 2 x_j) to x_i
        rows = m.sum(dim=1, keepdim=True)
        dx[r0:r1] = 2.0 * (x[r0:r1].to(m.dtype) * rows - (m.to(x.dtype) @ x).to(m.dtype))
    return dx.to(x.dtype)


def row_pairs_reference(xr: torch.Tensor, x: torch.Tensor, at: int, t: float, block: int,
                        need_grad: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Half the sum over j != i of exp(-t max(d2_ij, 0)) for the rows i,
    ``xr``, which are the rows ``at:at + len(xr)`` of ``x``, and (with
    ``need_grad``) the whole pair sum's gradient for them, in f32 (float64
    for float64 x); the gradient is computed block by block beside the
    sum, as it has each block at hand."""
    acc = acc_dtype(x)
    sq = (x.to(acc) ** 2).sum(dim=-1)
    sqr = sq[at:at + xr.shape[0]]
    total = torch.zeros((), dtype=acc, device=x.device)
    dx = torch.empty(xr.shape, dtype=acc, device=x.device) if need_grad else None
    for r0 in range(0, xr.shape[0], block):
        r1 = min(r0 + block, xr.shape[0])
        d2 = _pair_d2(xr[r0:r1], x, sqr[r0:r1], sq)
        e = d2.clamp(min=0.0).mul_(-t).exp_()
        e[:, at + r0:at + r1].fill_diagonal_(0.0)
        total += e.sum()
        if dx is not None:
            # as pair_sum_backward_reference: max(d2, 0)'s derivative
            m = e.masked_fill_(d2 < 0, 0.0).masked_fill_(d2 == 0, 0.5).mul_(-t)
            del d2
            m[:, at + r0:at + r1].fill_diagonal_(0.0)
            rows = m.sum(dim=1, keepdim=True)
            dx[r0:r1] = 2.0 * (xr[r0:r1].to(acc) * rows - (m.to(x.dtype) @ x).to(acc))
    return 0.5 * total, dx


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def pair_tiles(n: int, at: int = 0, rows: Optional[int] = None) -> np.ndarray:
    """K5's tiles, (items, 2) int32: the first row (counted from ``at``) and
    the first column of each tile of TILE rows x GRAM_COLS columns of the
    Gram matrix.  The whole sum (``rows`` None) takes the tiles that hold
    a pair i < j (the kernel keeps j > i inside them), in groups of GROUP
    rows x GROUP columns, groups by column then row, tiles in a group by
    column then row, so that the rows a wave of 132 blocks reads (about
    6 MB at D = 768) stay in L2.  A share (rows [at, at + rows) against
    all n) takes every tile, column by column, rows fastest."""
    whole = rows is None
    rows = n if whole else rows
    rt, ct = -(-rows // TILE), -(-n // GRAM_COLS)
    i, j = (a.ravel() for a in np.meshgrid(np.arange(rt), np.arange(ct), indexing="ij"))
    if whole:
        keep = (j + 1) * GRAM_COLS - 1 > i * TILE
        i, j = i[keep], j[keep]
    gi, gj = (GROUP // TILE, GROUP // GRAM_COLS) if whole else (rt, ct)
    order = np.lexsort((i, j, i // gi, j // gj))
    return np.stack([i[order] * TILE, j[order] * GRAM_COLS], axis=1).astype(np.int32)


def chunk_rows(D: int, sms: int) -> int:
    """K5b's rows a chunk: as many 128-row tiles as make the product's
    output tiles (row tiles x ceil(D / 128) column tiles) fill the ``sms``
    SMs once, at most MAX_CHUNK_ROWS rows (m's scratch is chunk x n in the
    rows' dtype).  D = 768 on 132 SMs: 22 row tiles, 2816 rows, 132 output
    tiles; at the flagship's 43,264 rows 244 MB of scratch in bf16, 487 MB
    in f32 (the plain f32 version's block of 2048 rows held ~0.9 GB)."""
    tiles = max(1, min(sms // -(-D // TILE), MAX_CHUNK_ROWS // TILE))
    return tiles * TILE


@functools.lru_cache(maxsize=16)
def _device_tiles(device: torch.device, n: int, at: int, rows: Optional[int]) -> torch.Tensor:
    return torch.from_numpy(pair_tiles(n, at, rows)).to(device)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def on_kernels(x: torch.Tensor) -> bool:
    """Whether ``x`` takes K5 and K5b: a CUDA tensor."""
    return x.device.type == "cuda"


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _checked(x: torch.Tensor, at: int, rows: int) -> torch.Tensor:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the uniformity kernels take float32 or bfloat16 rows, got {x.dtype}")
    lanes = 16 // x.element_size()
    if x.dim() != 2 or x.shape[1] % lanes:
        raise ValueError(f"the uniformity kernels take {x.dtype} rows (n, D) with D a multiple "
                         f"of {lanes}, got {tuple(x.shape)}")
    if not (0 <= at and 0 < rows and at + rows <= x.shape[0]):
        raise ValueError(f"rows [{at}, {at + rows}) outside the {x.shape[0]} rows of x")
    x = x.contiguous()
    return x.clone() if x.data_ptr() % 16 else x


def _norms_scratch(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(-(-x.shape[0] // 8) * 8, dtype=torch.float32, device=x.device)


def _pair_sum(x: torch.Tensor, t: float, at: int, rows: int) -> torch.Tensor:
    """K5 on the rows [at, at + rows) of x against all of them: the sum
    over i < j when they are all the rows, else half the sum over j != i;
    f32."""
    x = _checked(x, at, rows)
    n, D = x.shape
    tiles = _device_tiles(x.device, n, at, None if rows == n else rows)
    partials = torch.empty(8 * tiles.shape[0], dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    lib, fn = kernel_entry("uniform_pairs", "pipnet_uniform_pairs",
                           [ctypes.c_void_p] + [ctypes.c_int] * 5
                           + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
                           + [ctypes.c_void_p] * 4)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], n, D, at, rows, float(t),
                  tiles.data_ptr(), tiles.shape[0], _norms_scratch(x).data_ptr(),
                  partials.data_ptr(), out.data_ptr(), _stream(x.device))
    check_cuda(lib, code, "uniform pair sum launch")
    uniform_pairs.launches += 1
    return out


def _pair_grad(x: torch.Tensor, g: Optional[torch.Tensor], t: float, at: int,
               rows: int) -> torch.Tensor:
    """K5b: the whole pair sum's gradient for the rows [at, at + rows) of
    x; scaled by the cotangent ``g`` and in x's dtype, or with g None (a
    rank's rows on a mesh, which its caller scales) in f32."""
    x = _checked(x, at, rows)
    n, D = x.shape
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    chunk = min(chunk_rows(D, sms), -(-rows // TILE) * TILE)
    lanes = 16 // x.element_size()
    w_ld = -(-n // lanes) * lanes
    w = torch.empty((chunk, w_ld), dtype=x.dtype, device=x.device)
    rowpart = torch.empty((chunk, -(-n // GRAM_COLS)), dtype=torch.float32, device=x.device)
    dx = torch.empty((rows, D), dtype=torch.float32 if g is None else x.dtype, device=x.device)
    if g is not None:
        g = g.detach().to(device=x.device, dtype=torch.float32).contiguous()
    lib, fn = kernel_entry("uniform_pairs", "pipnet_uniform_pairs_backward",
                           [ctypes.c_void_p] + [ctypes.c_int] * 5
                           + [ctypes.c_float] + [ctypes.c_void_p] * 3
                           + [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 3)
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), _DTYPE_CODES[x.dtype], n, D, at, rows, float(t),
                  None if g is None else g.data_ptr(), _norms_scratch(x).data_ptr(),
                  w.data_ptr(), w_ld, chunk, rowpart.data_ptr(), dx.data_ptr(),
                  _stream(x.device))
    check_cuda(lib, code, "uniform pair gradient launch")
    uniform_pairs_backward.launches += 1
    return dx


def uniform_pairs(x: torch.Tensor, t: float, block: int = UNIFORM_BLOCK) -> torch.Tensor:
    """The pair sum over i < j of the rows of ``x`` (n, D): K5 for CUDA
    rows, else ``pair_sum_reference``; f32 (float64 for float64 CPU
    rows)."""
    if on_kernels(x):
        return _pair_sum(x, t, 0, x.shape[0])
    return pair_sum_reference(x, t, block)


uniform_pairs.launches = 0


def uniform_pairs_backward(x: torch.Tensor, g: torch.Tensor, t: float,
                           block: int = UNIFORM_BLOCK) -> torch.Tensor:
    """g times the pair sum's gradient for the rows of ``x``, in x's dtype:
    K5b for CUDA rows, else ``pair_sum_backward_reference``."""
    if on_kernels(x):
        return _pair_grad(x, g, t, 0, x.shape[0])
    return pair_sum_backward_reference(x, g, t, block)


uniform_pairs_backward.launches = 0


def row_pairs(xr: torch.Tensor, x: torch.Tensor, at: int, t: float, block: int,
              need_grad: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A mesh rank's share of the pair sum for its rows ``xr`` (the rows
    ``at:at + len(xr)`` of ``x``, every rank's rows) and, with
    ``need_grad``, the whole pair sum's gradient for them in f32 (float64
    for float64 CPU rows): K5 and K5b on the row range for CUDA rows, else
    ``row_pairs_reference``."""
    if not on_kernels(x):
        return row_pairs_reference(xr, x, at, t, block, need_grad)
    rows = xr.shape[0]
    share = _pair_sum(x, t, at, rows)
    return share, _pair_grad(x, None, t, at, rows) if need_grad else None
