"""K4: one ConvNeXt block branch (depthwise 7x7 + bias -> LayerNorm -> Linear
C->4C -> GELU -> Linear 4C->C -> layer-scale) as hand-written CUDA kernels
for Hopper, with its exact gradient by recompute.

Replaces ``pipnet_tpu/ops/pallas_convnext.py::_cnblock_kernel`` (behind
``make_fused_cnblock``); its kernels are in ``csrc/cnblock.cu``, built for
``sm_90a`` at first use (``ops/build.py``) and bound with ``ctypes``.  Its
depthwise stage is K3's device code (``csrc/dwconv_tile.cuh``).

What bounds K4 on an H100: the two products, 16 * pixels * C^2 operations
(817 GFLOP at B=128 and stage 3, 0.83 ms at the 989 TFLOP/s bf16 peak;
12.2 ms at the 67 TFLOP/s f32 SIMT rate), above its input and output bytes
(266 MB in bf16, 79 us).  In both dtypes it is three launches, each with a
plain version here: ``cnblock_dwln`` (depthwise + LayerNorm, z to device
memory), ``cnblock_up`` (h1 = GELU(z W1 + b1)) and ``cnblock_down`` ((h1
W2 + b2) * layer_scale), the last two one product kernel with a fused
epilogue: in bf16 TMA + ``wgmma`` tiled by ``gemm_plan``, in f32 a
register-tiled SIMT product (``csrc/simt_tile.cuh``, shared with K1's f32
kernel) tiled by ``gemm_plan_f32``; h1 makes one round trip through device
memory.  See the source.

Three functions of the same inputs, in the JAX package's layout (x
(B, H, W, C), dw_kernel (7, 7, C), w1 (C, 4C), w2 (4C, C), vectors):

* ``cnblock_branch_unfused``: the eager composition, the counterpart of
  ``cnblock_branch_xla``; ``CNBlock``'s unfused path and the recompute of
  K4's backward;
* ``cnblock_branch_reference``: the plain version of K4 in the Pallas
  kernel's rounding order (f32 taps, LayerNorm with its scale and bias in
  f32, f32 accumulation and GELU, one cast each of z, h1 and the output),
  which differs from the unfused composition's in bf16: the composition of
  ``cnblock_dwln_reference``, ``cnblock_up_reference`` and
  ``cnblock_down_reference``;
* ``cnblock_branch``: the wrapper.  CUDA tensors go through K4 (or raise),
  CPU tensors through ``cnblock_branch_reference``; ``cnblock_branch.
  launches`` counts kernel launches (3 a call in either dtype).  With
  autograd recording and an input that needs a gradient it goes through
  ``FusedCNBlock``, which saves only its inputs and recomputes the unfused
  composition in its backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .build import check_cuda, kernel_entry
from .dwconv import dwconv7x7_taps_f32

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


def cnblock_dwln_reference(x, dw_kernel, dw_bias, ln_scale, ln_bias) -> torch.Tensor:
    """Plain version of K4's first launch: depthwise taps and bias in f32
    from x cast to f32, LayerNorm (centred variance, eps 1e-6) with its
    scale and bias in f32, z cast to x's dtype: (B, H, W, C)."""
    f = lambda t: t.float()  # noqa: E731
    h = dwconv7x7_taps_f32(x, dw_kernel) + f(dw_bias)
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    return ((h - mu) * torch.rsqrt(var + 1e-6) * f(ln_scale) + f(ln_bias)).to(x.dtype)


def cnblock_up_reference(z, w1, b1, *, fast_gelu: bool) -> torch.Tensor:
    """Plain version of the second launch: h1 = GELU(z w1 + b1), the product
    accumulated in f32, b1 and GELU in f32, cast to z's dtype: (..., 4C)."""
    return _gelu(z.float() @ w1.float() + b1.float(), fast_gelu).to(z.dtype)


def cnblock_down_reference(h1, w2, b2, layer_scale) -> torch.Tensor:
    """Plain version of the third launch: ((h1 w2) + b2) * layer_scale in
    f32, cast once to h1's dtype: (..., C)."""
    return ((h1.float() @ w2.float() + b2.float()) * layer_scale.float()).to(h1.dtype)


def cnblock_branch_reference(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2,
                             layer_scale, *, fast_gelu: bool) -> torch.Tensor:
    """Plain PyTorch version of K4, in the Pallas kernel's rounding order
    (``pallas_convnext.py:72-97``): the three pieces above, z and h1 each
    rounded once to the dtype."""
    z = cnblock_dwln_reference(x, dw_kernel, dw_bias, ln_scale, ln_bias)
    h1 = cnblock_up_reference(z, w1, b1, fast_gelu=fast_gelu)
    return cnblock_down_reference(h1, w2, b2, layer_scale)


class GemmPlan(NamedTuple):
    """The tiling of one product launch (``csrc/cnblock.cu::cnblock_gemm``):
    output tiles of 128 rows x ``bn`` columns, ``grid_m`` x ``grid_n`` of
    them (column tiles the fastest grid index), and ``k_steps`` depth
    stages of 64 (TMA fills zeros past every edge)."""
    bn: int
    grid_m: int
    grid_n: int
    k_steps: int


GEMM_ROWS, GEMM_DEPTH = 128, 64     # BM and BK of csrc/head_tile.cuh::hopper
# the f32 product's tile (csrc/simt_tile.cuh: BM, BN, BK)
F32_GEMM_ROWS, F32_GEMM_COLS, F32_GEMM_DEPTH = 128, 128, 32


def gemm_plan(M: int, N: int, K: int) -> GemmPlan:
    """The bf16 plan of an (M, K) x (K, N) product: 256-column tiles where
    they divide N (a 64 x 256 f32 accumulator is 128 registers a thread),
    else 128 (N = 96 and 192 leave part of one tile empty)."""
    bn = 256 if N % 256 == 0 else 128
    return GemmPlan(bn, -(-M // GEMM_ROWS), -(-N // bn), -(-K // GEMM_DEPTH))


def gemm_plan_f32(M: int, N: int, K: int) -> GemmPlan:
    """The f32 plan of an (M, K) x (K, N) product: 128 x 128 output tiles
    (8 x 8 outputs for each of 256 threads), column tiles the fastest grid
    index, 32-deep ring stages (cp.async fills zeros past every edge)."""
    return GemmPlan(F32_GEMM_COLS, -(-M // F32_GEMM_ROWS), -(-N // F32_GEMM_COLS),
                    -(-K // F32_GEMM_DEPTH))


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
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the fused block kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the fused block kernel needs a contiguous x")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_part(what: str, first: torch.Tensor, *rest: torch.Tensor) -> None:
    """Raise unless every tensor has ``first``'s dtype (float32 or bfloat16)
    and CUDA device, and ``first`` is contiguous and 16-byte aligned (TMA
    or cp.async reads it)."""
    if first.device.type != "cuda":
        raise ValueError(f"{what} launches on cuda, not {first.device}")
    if first.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} takes float32 or bfloat16, got {first.dtype}")
    for t in (first, *rest):
        if t.device != first.device:
            raise ValueError(f"{what}: inputs on {first.device} and {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{what}: one dtype throughout, got {first.dtype} and {t.dtype}")
    if not first.is_contiguous() or first.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous, 16-byte aligned input")


def cnblock_dwln(x, dw_kernel, dw_bias, ln_scale, ln_bias) -> torch.Tensor:
    """K4's first launch: z (B, H, W, C) = LayerNorm(depthwise(x) + dw_bias)
    * ln_scale + ln_bias in x's dtype; CPU tensors take its plain version."""
    if x.device.type == "cpu":
        return cnblock_dwln_reference(x, dw_kernel, dw_bias, ln_scale, ln_bias)
    _check_part("the depthwise + LayerNorm launch", x, dw_kernel, dw_bias, ln_scale, ln_bias)
    B, H, W, C = x.shape
    if C % 8 or not 0 < C <= MAX_CHANNELS or tuple(dw_kernel.shape) != (7, 7, C):
        raise ValueError(f"the depthwise + LayerNorm launch takes C a multiple of 8 up to "
                         f"{MAX_CHANNELS} and a (7, 7, C) kernel, got {tuple(x.shape)} and "
                         f"{tuple(dw_kernel.shape)}")
    keep = [t.contiguous() for t in (dw_kernel, dw_bias, ln_scale, ln_bias)]
    z = torch.empty_like(x)
    lib, fn = kernel_entry("cnblock", "pipnet_cnblock_dwln",
                           [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    with torch.cuda.device(x.device):
        code = fn(x.data_ptr(), *[t.data_ptr() for t in keep], z.data_ptr(), B, H, W, C,
                  _DTYPE_CODES[x.dtype], _stream(x.device))
    check_cuda(lib, code, "depthwise + LayerNorm launch")
    cnblock_branch.launches += 1
    return z


_GELU_BIAS, _BIAS_SCALE = 0, 1      # the epilogues of csrc/cnblock.cu::cnblock_gemm


def _gemm(a, w, bias, scale: Optional[torch.Tensor], epilogue: int,
          fast_gelu: bool) -> torch.Tensor:
    """One product launch: epilogue(a (..., K) @ w (K, N)), w in the JAX
    layout (the kernels read w^T, nn.Linear's layout, K-major)."""
    what = "the block's product launch"
    _check_part(what, a, w, bias, *([] if scale is None else [scale]))
    K, N = w.shape
    wt = w.t().contiguous()          # a Linear weight's .t() view: no copy
    if a.shape[-1] != K or K % 8 or N % 8 or wt.data_ptr() % 16 or tuple(bias.shape) != (N,) \
            or (scale is not None and tuple(scale.shape) != (N,)):
        raise ValueError(f"{what}: a {tuple(a.shape)}, w {tuple(w.shape)}, bias "
                         f"{tuple(bias.shape)}: K and N multiples of 8, a 16-byte aligned w")
    rows = a.numel() // K
    keep = [bias.contiguous(), (bias if scale is None else scale).contiguous()]
    if any(t.data_ptr() % 4 for t in keep):
        raise ValueError(f"{what}: bias and scale are read as pairs, 4-byte aligned")
    out = torch.empty((*a.shape[:-1], N), dtype=a.dtype, device=a.device)
    ptrs = (a.data_ptr(), wt.data_ptr(), keep[0].data_ptr(), keep[1].data_ptr(), out.data_ptr())
    if a.dtype == torch.float32:
        plan = gemm_plan_f32(rows, N, K)
        lib, fn = kernel_entry("cnblock", "pipnet_cnblock_gemm_f32",
                               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
        args = (*ptrs, rows, N, K, plan.grid_m, plan.grid_n, epilogue, int(fast_gelu))
    else:
        plan = gemm_plan(rows, N, K)
        lib, fn = kernel_entry("cnblock", "pipnet_cnblock_gemm",
                               [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        args = (*ptrs, rows, N, K, *plan, epilogue, int(fast_gelu))
    with torch.cuda.device(a.device):
        code = fn(*args, _stream(a.device))
    check_cuda(lib, code, "block product launch")
    cnblock_branch.launches += 1
    return out


def cnblock_up(z, w1, b1, *, fast_gelu: bool) -> torch.Tensor:
    """K4's second launch: h1 = GELU(z w1 + b1), (..., 4C) in z's dtype; CPU
    tensors take its plain version."""
    if z.device.type == "cpu":
        return cnblock_up_reference(z, w1, b1, fast_gelu=fast_gelu)
    return _gemm(z, w1, b1, None, _GELU_BIAS, fast_gelu)


def cnblock_down(h1, w2, b2, layer_scale) -> torch.Tensor:
    """K4's third launch: (h1 w2 + b2) * layer_scale, (..., C) in h1's dtype;
    CPU tensors take its plain version."""
    if h1.device.type == "cpu":
        return cnblock_down_reference(h1, w2, b2, layer_scale)
    return _gemm(h1, w2, b2, layer_scale, _BIAS_SCALE, False)


def _forward(x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, layer_scale, *,
             fast_gelu: bool) -> torch.Tensor:
    args = (x, dw_kernel, dw_bias, ln_scale, ln_bias, w1, b1, w2, b2, layer_scale)
    if x.device.type == "cpu":
        return cnblock_branch_reference(*args, fast_gelu=fast_gelu)
    if x.device.type != "cuda":
        raise ValueError(f"the fused block runs on cuda or cpu, not {x.device}")
    check_cnblock_inputs(*args)
    z = cnblock_dwln(x, dw_kernel, dw_bias, ln_scale, ln_bias)
    h1 = cnblock_up(z, w1, b1, fast_gelu=fast_gelu)
    return cnblock_down(h1, w2, b2, layer_scale)


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
