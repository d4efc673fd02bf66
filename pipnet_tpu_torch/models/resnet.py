"""ResNet backbones in PyTorch with the PIP-Net stride surgery, and the
port's BatchNorm.

Counterpart of the JAX package's ``models/resnet.py`` (itself the
reference's ``features/resnet_features.py:126-229``): the torchvision ResNet
conv stack without its classifier and with **stride 1 in layer3 and layer4**
(``layer_strides`` (1, 2, 1, 1)), so 224^2 images give 28x28 latents.
Inputs and outputs are channels-last ``(B, H, W, C)``; the convolutions see
a channels-last-strided NCHW view.  Parameters stay float32 and are cast to
the compute dtype inside ``forward``, as the JAX package does.  Module names
follow the flax tree (``conv1``, ``bn1``, ``layer{l}_block{b}`` with
``conv{i}``, ``bn{i}``, ``down_conv``, ``down_bn``), so
``resnet_param_groups`` and ``models/convert.py`` map them one for one.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

BN_MOMENTUM, BN_EPS = 0.9, 1e-5


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype)`` over
    the last axis of a channels-last tensor.

    ``train`` normalises with the batch's statistics, computed in f32 (the
    output is cast to the input's dtype), and moves ``running_mean`` and
    ``running_var`` (f32 buffers) towards them by 0.1.  The running
    variance is the *biased* batch variance, as flax keeps it in
    ``batch_stats['var']``; ``torch.nn.BatchNorm2d`` keeps the unbiased
    one.  Without ``train`` the running statistics normalise.  Whether
    parameters take gradients does not matter: frozen layers update their
    statistics too, as the JAX step's ``mutable=["batch_stats"]`` does over
    the whole backbone."""

    def __init__(self, dim: int, momentum: float = BN_MOMENTUM, eps: float = BN_EPS):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        C = x.shape[-1]
        rows = x.reshape(-1, C)
        if not train:
            y = F.batch_norm(rows, self.running_mean, self.running_var, self.weight,
                             self.bias, training=False, eps=self.eps)
            return y.reshape(x.shape)
        # momentum 1 on scratch buffers: they receive the batch mean and the
        # unbiased batch variance, which this module converts and keeps
        mean = torch.zeros_like(self.running_mean)
        var = torch.zeros_like(self.running_var)
        y = F.batch_norm(rows, mean, var, self.weight, self.bias, training=True,
                         momentum=1.0, eps=self.eps)
        n = rows.shape[0]
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_(mean * (1.0 - m))
            self.running_var.mul_(m).add_(var * ((n - 1) / n * (1.0 - m)))
        return y.reshape(x.shape)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``conv`` on the channels-last ``x`` in ``dtype`` (no bias: the ResNet
    convolutions have none)."""
    return _nhwc(F.conv2d(_nchw(x), conv.weight.to(dtype), None, conv.stride, conv.padding))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        if downsample:
            self.down_conv = nn.Conv2d(inplanes, planes, 1, stride=stride, bias=False)
            self.down_bn = BatchNorm(planes)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, dtype: torch.dtype, train: bool) -> torch.Tensor:
        out = F.relu(self.bn1(_conv(self.conv1, x, dtype), train))
        out = self.bn2(_conv(self.conv2, out, dtype), train)
        identity = self.down_bn(_conv(self.down_conv, x, dtype), train) if self.downsample else x
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        if downsample:
            self.down_conv = nn.Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False)
            self.down_bn = BatchNorm(planes * 4)
        self.downsample = downsample

    def forward(self, x: torch.Tensor, dtype: torch.dtype, train: bool) -> torch.Tensor:
        out = F.relu(self.bn1(_conv(self.conv1, x, dtype), train))
        out = F.relu(self.bn2(_conv(self.conv2, out, dtype), train))
        out = self.bn3(_conv(self.conv3, out, dtype), train)
        identity = self.down_bn(_conv(self.down_conv, x, dtype), train) if self.downsample else x
        return F.relu(out + identity)


class ResNetFeatures(nn.Module):
    """ResNet conv stack; ``layer_strides`` defaults to PIP-Net's (1, 2, 1, 1)."""

    def __init__(self, block=Bottleneck, layers: Sequence[int] = (3, 4, 6, 3),
                 layer_strides: Sequence[int] = (1, 2, 1, 1), dtype: torch.dtype = torch.float32):
        super().__init__()
        self.block, self.layers, self.dtype = block, tuple(layers), dtype
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64)
        inplanes = 64
        for li, (blocks, planes) in enumerate(zip(self.layers, (64, 128, 256, 512))):
            for bi in range(blocks):
                s = layer_strides[li] if bi == 0 else 1
                down = bi == 0 and (s != 1 or inplanes != planes * block.expansion)
                self.add_module(f"layer{li + 1}_block{bi}", block(inplanes, planes, s, down))
                inplanes = planes * block.expansion

    @property
    def out_channels(self) -> int:
        return 512 * self.block.expansion

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, S, 3) -> features (B, S/8, S/8, C) in the compute dtype.
        ``train`` normalises with batch statistics and updates the running
        ones; ``generator`` is unused (no stochastic layer)."""
        dt = self.dtype
        x = F.relu(self.bn1(_conv(self.conv1, x.to(dt), dt), train))
        x = _nhwc(F.max_pool2d(_nchw(x), 3, stride=2, padding=1))
        for li, blocks in enumerate(self.layers):
            for bi in range(blocks):
                x = getattr(self, f"layer{li + 1}_block{bi}")(x, dt, train)
        return x.contiguous()


# (blocks per layer, bottleneck) of each named ResNet
RESNET_SPECS = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet50_inat": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}


def resnet18_features(dtype=torch.float32) -> ResNetFeatures:
    return ResNetFeatures(BasicBlock, (2, 2, 2, 2), dtype=dtype)


def resnet34_features(dtype=torch.float32) -> ResNetFeatures:
    return ResNetFeatures(BasicBlock, (3, 4, 6, 3), dtype=dtype)


def resnet50_features(dtype=torch.float32) -> ResNetFeatures:
    return ResNetFeatures(Bottleneck, (3, 4, 6, 3), dtype=dtype)


# the iNaturalist-pretrained variant shares the architecture; only the
# imported checkpoint differs (ref features/resnet_features.py:273-301)
resnet50_features_inat = resnet50_features


def resnet101_features(dtype=torch.float32) -> ResNetFeatures:
    return ResNetFeatures(Bottleneck, (3, 4, 23, 3), dtype=dtype)


def resnet152_features(dtype=torch.float32) -> ResNetFeatures:
    return ResNetFeatures(Bottleneck, (3, 8, 36, 3), dtype=dtype)


def resnet_param_groups(modules: Iterable[str], arch: str) -> Dict[str, str]:
    """Optimizer group of each top-level backbone module (the reference's
    partition, ``util/args.py:464-499``, with the JAX package's quirks: the
    last block of layer4 -> 'train'; the rest of layers 3 and 4 ->
    'freeze'; layer2 -> 'backbone'; the stem and layer1 -> 'frozen' for
    resnet50 (and resnet50_inat), 'backbone' for the others)."""
    if "resnet18" in arch:
        last, early = "layer4_block1", "backbone"
    elif any(a in arch for a in ("resnet34", "resnet50", "resnet101", "resnet152")):
        last, early = "layer4_block2", "frozen" if "resnet50" in arch else "backbone"
    else:
        raise ValueError(f"unknown resnet arch {arch}")
    groups = {}
    for name in modules:
        if name == last:
            groups[name] = "train"
        elif name.startswith(("layer4", "layer3")):
            groups[name] = "freeze"
        elif name.startswith("layer2"):
            groups[name] = "backbone"
        else:
            groups[name] = early
    return groups
