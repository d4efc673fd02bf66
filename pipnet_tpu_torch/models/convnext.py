"""ConvNeXt-Tiny backbone in PyTorch, with the PIP-Net stride surgery.

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
as the JAX package does.  Training applies row-mode stochastic depth (a
block's whole residual branch dropped per sample, with a probability that
ramps linearly over the blocks) from an explicit ``torch.Generator``.
``fused`` (the configuration's ``use_pallas_backbone``) runs each block's
branch through K4 (``ops/cnblock.py``); the Gaussian multiplier is not
ported yet.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.cnblock import cnblock_branch, cnblock_branch_unfused

CONVNEXT_TINY_DEPTHS = (3, 3, 9, 3)
CONVNEXT_TINY_DIMS = (96, 192, 384, 768)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class ChannelLayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-6, dtype=dtype)`` over the last axis:
    statistics in f32 (float64 inputs keep float64; variance as E[x^2] -
    E[x]^2, clipped at 0), scale and bias applied in that type, result cast
    to ``dtype``."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        mu = x32.mean(-1, keepdim=True)
        var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mu * mu, min=0.0)
        y = (x32 - mu) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias
        return y.to(dtype)


class CNBlock(nn.Module):
    """ConvNeXt block: dw7x7 -> LN -> MLP(4x, GELU) -> layer-scale -> +residual.
    The block LN is computed in f32 and cast back (JAX ``convnext.py:107-111``).
    With ``fused`` the branch is K4 (``cnblock_branch``), in its own rounding
    order.  Parameters are cast to the compute dtype before the branch, so
    autograd carries their gradients back to the f32 parameters."""

    def __init__(self, dim: int, fast_gelu: bool = False, sd_prob: float = 0.0,
                 fused: bool = False):
        super().__init__()
        self.fast_gelu, self.sd_prob, self.fused = fast_gelu, sd_prob, fused
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm_scale = nn.Parameter(torch.ones(dim))
        self.norm_bias = nn.Parameter(torch.zeros(dim))
        self.mlp_in = nn.Linear(dim, 4 * dim)
        self.mlp_out = nn.Linear(4 * dim, dim)
        self.layer_scale = nn.Parameter(torch.full((dim,), 1e-6))

    def branch_params(self, dtype: torch.dtype) -> tuple:
        """The branch's nine parameters cast to ``dtype``, in the JAX layout
        (dw kernel (7, 7, C), dense kernels (in, out)) as views."""
        C = self.norm_scale.shape[0]
        cast = lambda p: p.to(dtype)  # noqa: E731
        return (cast(self.dwconv.weight).reshape(C, 7, 7).permute(1, 2, 0),
                cast(self.dwconv.bias), cast(self.norm_scale), cast(self.norm_bias),
                cast(self.mlp_in.weight).t(), cast(self.mlp_in.bias),
                cast(self.mlp_out.weight).t(), cast(self.mlp_out.bias), cast(self.layer_scale))

    def forward(self, x: torch.Tensor, dtype: torch.dtype, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        residual = x
        branch = cnblock_branch if self.fused else cnblock_branch_unfused
        h = branch(x.to(dtype).contiguous(), *self.branch_params(dtype),
                   fast_gelu=self.fast_gelu)
        if train and self.sd_prob > 0.0:
            keep = 1.0 - self.sd_prob
            mask = torch.rand((x.shape[0], 1, 1, 1), generator=generator,
                              device=x.device) < keep
            h = torch.where(mask, h / keep, torch.zeros_like(h))
        return residual + h


class ConvNeXtTiny(nn.Module):
    """ConvNeXt-Tiny feature extractor (no pooling/classifier).

    ``stride_threshold``: downsampling convs with ``in_channels > threshold``
    use stride 1 (keeping their 2x2 kernel VALID padding, so each such stage
    shrinks the map by 1 pixel — this is what produces 26x26 from 224^2).
    Submodule names follow the JAX parameter tree (``stem_conv``,
    ``down{i}_norm``, ``stage{s}_block{b}``, ...) so ``models/convert.py``
    maps checkpoints one to one.  ``fused`` runs every block's branch
    through K4.
    """

    def __init__(self, stride_threshold: Optional[int] = 100,
                 depths: Sequence[int] = CONVNEXT_TINY_DEPTHS,
                 dims: Sequence[int] = CONVNEXT_TINY_DIMS,
                 fast_gelu: bool = False, dtype: torch.dtype = torch.float32,
                 stochastic_depth_prob: float = 0.1, fused: bool = False):
        super().__init__()
        self.depths, self.dims, self.dtype = tuple(depths), tuple(dims), dtype
        self.stem_conv = nn.Conv2d(3, dims[0], 4, stride=4)
        self.stem_norm = ChannelLayerNorm(dims[0])
        self.strides = [0]
        total_blocks, block_id = sum(depths), 0
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
                sd = stochastic_depth_prob * block_id / max(total_blocks - 1, 1)
                self.add_module(f"stage{stage}_block{blk}", CNBlock(dim, fast_gelu, sd, fused))
                block_id += 1

    @property
    def out_channels(self) -> int:
        return self.dims[-1]

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, H, W, 3) -> features (B, H', W', C) in the compute dtype.
        With ``train``, stochastic depth draws from ``generator``."""
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
                x = getattr(self, f"stage{stage}_block{blk}")(x, dt, train, generator)
        return x.contiguous()


def convnext_tiny_26(dtype=torch.float32, **kw) -> ConvNeXtTiny:
    return ConvNeXtTiny(stride_threshold=100, dtype=dtype, **kw)


def convnext_tiny_13(dtype=torch.float32, **kw) -> ConvNeXtTiny:
    return ConvNeXtTiny(stride_threshold=300, dtype=dtype, **kw)


def convnext_tiny_7(dtype=torch.float32, **kw) -> ConvNeXtTiny:
    return ConvNeXtTiny(stride_threshold=None, dtype=dtype, **kw)


def convnext_param_groups(modules: Iterable[str]) -> Dict[str, str]:
    """Optimizer group of each top-level backbone module (the reference's
    partition, ``util/args.py:500-515``): the last block of stage 4 ->
    'train'; the rest of stages 3/4 (torchvision features.6/7) -> 'freeze';
    stage 2's blocks and its downsampling (features.4/5) -> 'backbone';
    everything earlier -> 'frozen'."""
    groups = {}
    for name in modules:
        if name == "stage3_block2":                       # torchvision features.7.2
            groups[name] = "train"
        elif name.startswith("stage3") or name in ("down3_conv", "down3_norm"):
            groups[name] = "freeze"                       # features.7 / features.6
        elif name.startswith("stage2") or name in ("down2_conv", "down2_norm"):
            groups[name] = "backbone"                     # features.5 / features.4
        else:
            groups[name] = "frozen"                       # stem, stages 1-2 (features.0-3)
    return groups
