"""K4: one ConvNeXt block branch (depthwise 7x7 + bias -> LayerNorm -> Linear
C->4C -> GELU -> Linear 4C->C -> layer-scale) fused into one hand-written
CUDA kernel for Hopper, with its exact gradient by recompute.

Replaces ``pipnet_tpu/ops/pallas_convnext.py::_cnblock_kernel`` (behind
``make_fused_cnblock``); its kernel is ``csrc/cnblock.cu``, built for
``sm_90a`` at first use (``ops/build.py``) and bound with ``ctypes``.  Its
depthwise stage is K3's device code (``csrc/dwconv_tile.cuh``).

What bounds K4 on an H100: the two products, 16 * pixels * C^2 operations
(817 GFLOP at B=128 and stage 3, 0.83 ms at the 989 TFLOP/s bf16 peak),
above its input and output bytes (266 MB, 79 us).  A block owns 32 pixels
and all C channels; z and h1 stay in shared memory.  See the source.

Three functions of the same inputs, in the JAX package's layout (x
(B, H, W, C), dw_kernel (7, 7, C), w1 (C, 4C), w2 (4C, C), vectors):

* ``cnblock_branch_unfused``: the eager composition, the counterpart of
  ``cnblock_branch_xla``; ``CNBlock``'s unfused path and the recompute of
  K4's backward;
* ``cnblock_branch_reference``: the plain version of K4 in the Pallas
  kernel's rounding order (f32 taps, LayerNorm with its scale and bias in
  f32, f32 accumulation and GELU, one cast of the output), which differs
  from the unfused composition's in bf16;
* ``cnblock_branch``: the wrapper.  CUDA tensors go through K4 (or raise),
  CPU tensors through ``cnblock_branch_reference``; ``cnblock_branch.
  launches`` counts kernel launches.  With autograd recording and an input
  that needs a gradient it goes through ``FusedCNBlock``, which saves only
  its inputs and recomputes the unfused composition in its backward.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from .build import check_cuda, kernel_entry
from .dwconv import dwconv7x7_taps_f32
from .fused_head import _DTYPE_CODES

MAX_CHANNELS = 768          # MAX_C in csrc/cnblock.cu


def _gelu(h: torch.Tensor, fast_gelu: bool) -> torch.Tensor:
    return F.gelu(h, approximate="tanh" if fast_gelu else "none")


def cnblock_branch_unfused(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2,
                           layer_scale, *, fast_gelu: bool) -> torch.Tensor:
    """The block branch as the eager composition (JAX ``cnblock_branch_xla``,
    the flax CNBlock without the residual): each op in the input dtype, the
    LayerNorm statistics in f32 with the normalised value cast back before
    its scale and bias."""
    C = x.shape[-1]
    h = F.conv2d(x.permute(0, 3, 1, 2), dw_kernel.permute(2, 0, 1).unsqueeze(1),
                 padding=3, groups=C).permute(0, 2, 3, 1)
    h = h + dw_bias
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
    h = ((h32 - mu) * torch.rsqrt(var + 1e-6)).to(x.dtype)
    h = h * ln_scale + ln_bias
    h = _gelu(F.linear(h, w1.t(), b1), fast_gelu)
    h = F.linear(h, w2.t(), b2)
    return h * layer_scale


def cnblock_branch_reference(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2,
                             layer_scale, *, fast_gelu: bool) -> torch.Tensor:
    """Plain PyTorch version of K4, in the Pallas kernel's rounding order
    (``pallas_convnext.py:72-97``): depthwise taps and bias in f32 from x
    cast to f32; LayerNorm (centred variance) with its scale and bias in
    f32, cast to the dtype; each product accumulates in f32; b1 and GELU in
    f32, cast; b2 and layer-scale in f32, and one cast of the output."""
    dt = x.dtype
    f = lambda t: t.float()  # noqa: E731
    h = dwconv7x7_taps_f32(x, dw_kernel) + f(dw_bias)
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    z = ((h - mu) * torch.rsqrt(var + 1e-6) * f(ln_scale) + f(ln_bias)).to(dt)
    h1 = _gelu(f(z) @ f(w1) + f(b1), fast_gelu).to(dt)
    return ((f(h1) @ f(w2) + f(b2)) * f(layer_scale)).to(dt)


def check_cnblock_inputs(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2,
                         layer_scale) -> None:
    """Raise unless the inputs are what K4 takes: shapes as above with C a
    multiple of 8 up to ``MAX_CHANNELS``, one device, one dtype (float32 or
    bfloat16), and a contiguous x."""
    if x.dim() != 4:
        raise ValueError(f"expected x (B,H,W,C), got {tuple(x.shape)}")
    C = x.shape[-1]
    if C % 8 or not 0 < C <= MAX_CHANNELS:
        raise ValueError(f"the fused block kernel takes C a multiple of 8 up to "
                         f"{MAX_CHANNELS}, got {C}")
    want = {"dw_kernel": (7, 7, C), "dw_bias": (C,), "ln_scale": (C,), "ln_bias": (C,),
            "w1": (C, 4 * C), "b1": (4 * C,), "w2": (4 * C, C), "b2": (C,),
            "layer_scale": (C,)}
    given = dict(zip(want, (dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2,
                            layer_scale)))
    for name, t in given.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} shape {tuple(t.shape)} != {want[name]}")
        if t.device != x.device:
            raise ValueError(f"x on {x.device}, {name} on {t.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}: one dtype throughout")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"the fused block kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the fused block kernel needs a contiguous x")


def _launch(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, layer_scale,
            fast_gelu: bool) -> torch.Tensor:
    check_cnblock_inputs(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2,
                         layer_scale)
    B, H, W, C = x.shape
    # the kernel reads W1 and W2 transposed, as nn.Linear keeps them: for a
    # w1 that is a Linear weight's .t() view, .t().contiguous() copies nothing
    keep = [x, dw_kernel.contiguous(), dw_bias.contiguous(), ln_scale.contiguous(),
            ln_bias.contiguous(), w1.t().contiguous(), b1.contiguous(), w2.t().contiguous(),
            b2.contiguous(), layer_scale.contiguous()]
    params = (ctypes.c_void_p * 10)(*[t.data_ptr() for t in keep])
    out = torch.empty_like(x)
    lib, fn = kernel_entry("cnblock", "pipnet_cnblock_forward",
                           [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(ctypes.cast(params, ctypes.c_void_p), out.data_ptr(), B, H, W, C,
                  int(fast_gelu), _DTYPE_CODES[x.dtype], stream)
    check_cuda(lib, code, "fused block launch")
    cnblock_branch.launches += 1
    return out


def _forward(*args, fast_gelu: bool) -> torch.Tensor:
    x = args[0]
    if x.device.type == "cpu":
        return cnblock_branch_reference(*args, fast_gelu=fast_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"the fused block runs on cuda or cpu, not {x.device}")
    return _launch(*args, fast_gelu)


def cnblock_branch(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, layer_scale,
                   *, fast_gelu: bool) -> torch.Tensor:
    """The fused block branch (the contract of the JAX package's
    ``make_fused_cnblock``): (B, H, W, C) -> (B, H, W, C) in x's dtype.
    Without autograd recording, or with no input that needs a gradient
    (the frozen stages of a train step), it is one forward and saves
    nothing."""
    args = (x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, layer_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        return FusedCNBlock.apply(fast_gelu, *args)
    return _forward(*args, fast_gelu=fast_gelu)


cnblock_branch.launches = 0


class FusedCNBlock(torch.autograd.Function):
    """The branch through K4; backward: the VJP of
    ``cnblock_branch_unfused`` recomputed from the saved inputs, with the
    cotangent cast to x's dtype (``make_fused_cnblock``'s bwd)."""

    @staticmethod
    def forward(ctx, fast_gelu, *args):
        ctx.save_for_backward(*args)
        ctx.fast_gelu = fast_gelu
        return _forward(*args, fast_gelu=fast_gelu)

    @staticmethod
    def backward(ctx, g) -> Tuple:
        args = ctx.saved_tensors
        needs = ctx.needs_input_grad[1:]
        with torch.enable_grad():
            inputs = [a.detach().requires_grad_(n) for a, n in zip(args, needs)]
            out = cnblock_branch_unfused(*inputs, fast_gelu=ctx.fast_gelu)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(out, wanted, g.to(args[0].dtype)))
        return (None, *[next(grads) if n else None for n in needs])
