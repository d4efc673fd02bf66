"""K3: the depthwise 7x7 'SAME' convolution as a hand-written CUDA kernel
for Hopper, with its exact gradient.

Replaces ``pipnet_tpu/ops/pallas_dwconv.py::_dw_kernel`` (behind
``make_dwconv7x7``); its kernel is ``csrc/dwconv.cu``, built for ``sm_90a``
at first use (``ops/build.py``) and bound with ``ctypes``.  It shares the
weight loader of ``csrc/dwconv_tile.cuh`` with K4 (``ops/cnblock.py``),
whose first stage is the same 49 taps.  No model of either package runs
this op: the model's blocks take K4 (fused) or the unfused composition.

What bounds K3 on an H100, at B=128 and stage 3 (26x26x768, bf16): its
266 MB of input and output take 79 us at 3.35 TB/s, its 6.5 GFLOP of f32
FMA 97 us at the 67 TFLOP/s f32 peak, so operations on the SIMT units bound
it.  The kernel rolls rows down the image: a thread owns one channel and a
strip of output columns that divides W, loads each input row once into
registers and keeps the 7 output rows it feeds there (see the source).

``dwconv7x7`` runs the kernel for CUDA tensors and the plain PyTorch version
``dwconv7x7_reference`` for CPU tensors, with no fallback between them;
``dwconv7x7.launches`` counts kernel launches.  With autograd recording it
goes through ``DwConv7x7``, whose backward is K3 again on the flipped
kernel for dx (one launch) and the plain 49-tap reduction
``dwconv7x7_weight_grad`` for dw, as the JAX package leaves it to XLA.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .build import check_cuda, kernel_entry
from .fused_head import _DTYPE_CODES


def dwconv7x7_taps_f32(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """The depthwise 7x7 'SAME' conv in f32 as 49 shifted multiply-adds in
    the Pallas kernel's tap order: x (B, H, W, C), kernel (7, 7, C) -> f32."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 3, 3, 3, 3))
    k = kernel.float()
    acc = torch.zeros((B, H, W, C), dtype=torch.float32, device=x.device)
    for dy in range(7):
        for dx in range(7):
            acc = acc + xp[:, dy:dy + H, dx:dx + W, :] * k[dy, dx]
    return acc


def dwconv7x7_reference(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3: f32 taps, the output in x's dtype."""
    return dwconv7x7_taps_f32(x, kernel).to(x.dtype)


def dwconv7x7_weight_grad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """dL/dkernel (7, 7, C) in f32: ``sum_{b,y,x} xp[b, y+dy, x+dx] g[b, y, x]``
    per tap (the JAX package's ``_dw_weight_grad``)."""
    B, H, W, C = x.shape
    xp = F.pad(x.float(), (0, 0, 3, 3, 3, 3))
    g32 = g.float()
    return torch.stack([torch.stack([(xp[:, dy:dy + H, dx:dx + W, :] * g32).sum((0, 1, 2))
                                     for dx in range(7)]) for dy in range(7)])


def check_dwconv_inputs(x: torch.Tensor, kernel: torch.Tensor) -> None:
    """Raise unless x (B, H, W, C) and kernel (7, 7, C) are what K3 takes:
    one device, float32 or bfloat16 in both, contiguous."""
    if x.dim() != 4 or tuple(kernel.shape) != (7, 7, x.shape[-1]):
        raise ValueError(f"expected x (B,H,W,C) and kernel (7,7,C), got "
                         f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    if kernel.device != x.device:
        raise ValueError(f"x on {x.device}, kernel on {kernel.device}")
    if x.dtype not in _DTYPE_CODES or kernel.dtype != x.dtype:
        raise TypeError(f"depthwise conv takes float32 or bfloat16 x and a kernel of "
                        f"the same dtype, got {x.dtype} and {kernel.dtype}")
    if not (x.is_contiguous() and kernel.is_contiguous()):
        raise ValueError("depthwise conv needs contiguous x and kernel")


def _launch(x: torch.Tensor, kernel: torch.Tensor, flip: bool) -> torch.Tensor:
    check_dwconv_inputs(x, kernel)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    lib, fn = kernel_entry("dwconv", "pipnet_dwconv7x7",
                           [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), kernel.data_ptr(), out.data_ptr(), B, H, W, C, int(flip),
                  _DTYPE_CODES[x.dtype], stream)
    check_cuda(lib, code, "depthwise conv launch")
    dwconv7x7.launches += 1
    return out


def _forward(x: torch.Tensor, kernel: torch.Tensor, flip: bool = False) -> torch.Tensor:
    if x.device.type == "cpu":
        return dwconv7x7_reference(x, kernel.flip(0, 1) if flip else kernel)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise conv runs on cuda or cpu, not {x.device}")
    return _launch(x, kernel, flip)


def dwconv7x7(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 7x7 'SAME' conv (the contract of the JAX package's
    ``make_dwconv7x7``): x (B, H, W, C), kernel (7, 7, C) -> (B, H, W, C)
    in x's dtype.  CUDA tensors go through K3 (or raise); CPU tensors
    through ``dwconv7x7_reference``.  Differentiable through
    ``DwConv7x7``."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad):
        return DwConv7x7.apply(x, kernel)
    return _forward(x, kernel)


dwconv7x7.launches = 0


class DwConv7x7(torch.autograd.Function):
    """``(x, kernel) -> out`` through K3; backward: dx is K3 on the
    cotangent (cast to x's dtype) with the kernel flipped in both spatial
    axes, dw the plain 49-tap reduction (``make_dwconv7x7``'s VJP)."""

    @staticmethod
    def forward(ctx, x, kernel):
        ctx.save_for_backward(x, kernel)
        return _forward(x, kernel)

    @staticmethod
    def backward(ctx, g):
        x, kernel = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = _forward(g, kernel, flip=True) if ctx.needs_input_grad[0] else None
        dw = (dwconv7x7_weight_grad(x, g).to(kernel.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw
