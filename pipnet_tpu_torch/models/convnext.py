"""ConvNeXt-Tiny backbone in PyTorch, with the PIP-Net stride surgery
(inference only).

Counterpart of the JAX package's ``models/convnext.py`` and of the
reference backbone (``features/convnext_features.py:7-42``): torchvision's
ConvNeXt-Tiny without its classifier, where every stride-2 downsampling conv
whose input channel count exceeds a threshold is re-strided to 1:

* threshold 100 -> 26x26 latent at 224^2 (``convnext_tiny_26``)
* threshold 300 -> 13x13 (``convnext_tiny_13``)
* no surgery   -> 7x7  (``convnext_tiny_7``)

Inputs and outputs are channels-last ``(B, H, W, C)`` as in the JAX package;
the convolutions see a channels-last-strided NCHW view, so no copy is made.
Parameters stay float32 and are cast to the compute dtype inside ``forward``,
as the JAX package does.  Stochastic depth is a no-op at inference; the
Gaussian multiplier and row-mode stochastic depth come with the training
slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

CONVNEXT_TINY_DEPTHS = (3, 3, 9, 3)
CONVNEXT_TINY_DIMS = (96, 192, 384, 768)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ChannelLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6, dtype=dtype)`` over the last axis:
    statistics in f32 (variance as E[x^2] - E[x]^2, clipped at 0), scale and
    bias applied in f32, result cast to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x32 = x.float()
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(dtype)


class CNBlock(nn.Module):
    """ConvNeXt block: dw7x7 -> LN -> MLP(4x, GELU) -> layer-scale -> +residual.
    The block LN is computed in f32 and cast back (JAX ``convnext.py:107-111``)."""

    def __init__(self, dim: int, fast_gelu: bool = False):
        super().__init__()
        self.fast_gelu = fast_gelu
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm_scale = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.mlp_in = nn.Linear(dim, 4 * dim)
        self.mlp_out = nn.Linear(4 * dim, dim)
        self.layer_scale = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        residual = x
        h = _nhwc(F.conv2d(_nchw(x.to(dtype)), self.dwconv.weight.to(dtype),
                           padding=3, groups=x.shape[-1]))
        h = h + self.dwconv.bias.to(dtype)
        h32 = h.float()
        mu = h32.mean(-1, keepdim=True)
        var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
        h = ((h32 - mu) * torch.rsqrt(var + 1e-6)).to(dtype)
        h = h * self.norm_scale.to(dtype) + self.norm_bias.to(dtype)
        h = F.linear(h, self.mlp_in.weight.to(dtype), self.mlp_in.bias.to(dtype))
        h = F.gelu(h, approximate="tanh" if self.fast_gelu else "none")
        h = F.linear(h, self.mlp_out.weight.to(dtype), self.mlp_out.bias.to(dtype))
        return residual + h * self.layer_scale.to(dtype)


class ConvNeXtTiny(nn.Module):
    """ConvNeXt-Tiny feature extractor (no pooling/classifier).

    ``stride_threshold``: downsampling convs with ``in_channels > threshold``
    use stride 1 (keeping their 2x2 kernel VALID padding, so each such stage
    shrinks the map by 1 pixel — this is what produces 26x26 from 224^2).
    Submodule names follow the JAX parameter tree (``stem_conv``,
    ``down{i}_norm``, ``stage{s}_block{b}``, ...) so ``models/convert.py``
    maps checkpoints one to one.
    """

    def __init__(self, stride_threshold: Optional[int] = 100,
                 depths: Sequence[int] = CONVNEXT_TINY_DEPTHS,
                 dims: Sequence[int] = CONVNEXT_TINY_DIMS,
                 fast_gelu: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.depths, self.dims, self.dtype = tuple(depths), tuple(dims), dtype
        self.stem_conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = ChannelLayerNorm(dims[0])
        self.strides = [0]
        for stage, (depth, dim) in enumerate(zip(depths, dims)):
            if stage > 0:
                in_ch = dims[stage - 1]
                stride = 2
                if stride_threshold is not None and in_ch > stride_threshold:
                    stride = 1
                self.strides.append(stride)
                self.add_module(f"down{stage}_norm", ChannelLayerNorm(in_ch))
                self.add_module(f"down{stage}_conv",
                                nn.Conv2d(in_ch, dim, 2, stride=stride))
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", CNBlock(dim, fast_gelu))

    @property
    def out_channels(self) -> int:
        return self.dims[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, 3) -> features (B, H', W', C) in the compute dtype."""
        dt = self.dtype
        x = _nhwc(F.conv2d(_nchw(x.to(dt)), self.stem_conv.weight.to(dt),
                           self.stem_conv.bias.to(dt), stride=4))
        x = self.stem_norm(x, dt)
        for stage, depth in enumerate(self.depths):
            if stage > 0:
                conv = getattr(self, f"down{stage}_conv")
                x = getattr(self, f"down{stage}_norm")(x, dt)
                x = _nhwc(F.conv2d(_nchw(x), conv.weight.to(dt), conv.bias.to(dt),
                                   stride=self.strides[stage]))
            for blk in range(depth):
                x = getattr(self, f"stage{stage}_block{blk}")(x, dt)
        return x.contiguous()


def convnext_tiny_26(dtype=torch.float32, **kw) -> ConvNeXtTiny:
    return ConvNeXtTiny(stride_threshold=100, dtype=dtype, **kw)


def convnext_tiny_13(dtype=torch.float32, **kw) -> ConvNeXtTiny:
    return ConvNeXtTiny(stride_threshold=300, dtype=dtype, **kw)


def convnext_tiny_7(dtype=torch.float32, **kw) -> ConvNeXtTiny:
    return ConvNeXtTiny(stride_threshold=None, dtype=dtype, **kw)
