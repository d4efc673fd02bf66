"""DINOv2 ViT-S/14 backbone in PyTorch.

Counterpart of the JAX package's ``models/vit.py`` and of the reference's
``DinoV2`` wrapper (``pipnet/pipnet.py:1121-1132``, torch.hub
``dinov2_vits14``, ``x_norm_patchtokens`` reshaped to the patch grid):
patch embedding (conv 14x14, stride 14) -> + cls token and the learned
position embedding, resized to the grid -> 12 pre-LN blocks (6-head
attention and a 4x MLP, each with LayerScale) -> final LayerNorm; only the
patch tokens are returned, channels-last ``(B, S/14, S/14, dim)``.

The position embedding is trained at 518^2 (a 37x37 grid).  Another grid
resizes it as ``jax.image.resize(..., "bicubic")`` does: Keys' cubic with
a = -0.5 and antialiasing when it shrinks, which is
``F.interpolate(mode="bicubic", antialias=True)``.  Attention is an explicit
product and softmax, as the JAX package's einsums compute it.  Parameters
stay float32 and are cast to the compute dtype inside ``forward``;
LayerNorms take their statistics in f32 (``ChannelLayerNorm``).
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .convnext import ChannelLayerNorm


def _linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        B, N, D = x.shape
        H = self.num_heads
        qkv = _linear(self.qkv, x, dtype).reshape(B, N, 3, H, D // H)
        q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))          # (B, H, N, hd)
        attn = torch.softmax(torch.matmul(q * (D // H) ** -0.5, k.transpose(-1, -2)), dim=-1)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, D)
        return _linear(self.proj, out, dtype)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = ChannelLayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.ls1 = nn.Parameter(torch.full((dim,), 1e-5))
        self.norm2 = ChannelLayerNorm(dim)
        self.mlp_in = nn.Linear(dim, 4 * dim)
        self.mlp_out = nn.Linear(4 * dim, dim)
        self.ls2 = nn.Parameter(torch.full((dim,), 1e-5))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = self.attn(self.norm1(x, dtype), dtype)
        x = x + h * self.ls1.to(h.dtype)
        h = F.gelu(_linear(self.mlp_in, self.norm2(x, dtype), dtype))
        h = _linear(self.mlp_out, h, dtype)
        return x + h * self.ls2.to(h.dtype)


def resize_pos_embed(patch_pos: torch.Tensor, grid: int) -> torch.Tensor:
    """(1, G, G, D) position embedding -> (1, grid, grid, D), bicubic with
    a = -0.5 and antialiasing, as ``jax.image.resize(..., "bicubic")``."""
    if patch_pos.shape[1] == grid:
        return patch_pos
    out = F.interpolate(patch_pos.permute(0, 3, 1, 2), size=(grid, grid), mode="bicubic",
                        align_corners=False, antialias=True)
    return out.permute(0, 2, 3, 1)


class DinoV2ViT(nn.Module):
    """Returns channels-last patch features (B, S/14, S/14, dim).  Module
    names follow the flax tree (``patch_embed``, ``cls_token``,
    ``pos_embed``, ``block{i}``, ``norm``)."""

    def __init__(self, dim: int = 384, depth: int = 12, num_heads: int = 6, patch: int = 14,
                 pretrain_grid: int = 37, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dim, self.depth, self.patch, self.pretrain_grid = dim, depth, patch, pretrain_grid
        self.dtype = dtype
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrain_grid ** 2 + 1, dim))
        for i in range(depth):
            self.add_module(f"block{i}", Block(dim, num_heads))
        self.norm = ChannelLayerNorm(dim)

    @property
    def out_channels(self) -> int:
        return self.dim

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (B, S, S, 3) -> (B, S/14, S/14, dim) in the compute dtype.
        ``train`` and ``generator`` are unused (no stochastic layer)."""
        dt, D, G = self.dtype, self.dim, self.pretrain_grid
        B = x.shape[0]
        h = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.patch_embed.weight.to(dt),
                     self.patch_embed.bias.to(dt), stride=self.patch)
        g = h.shape[-1]
        h = h.flatten(2).transpose(1, 2)                              # (B, g*g, D)
        pos = self.pos_embed
        patch_pos = resize_pos_embed(pos[:, 1:].reshape(1, G, G, D), g)
        h = h + patch_pos.reshape(1, g * g, D).to(h.dtype)
        cls_tok = (self.cls_token + pos[:, :1]).to(h.dtype)
        h = torch.cat([cls_tok.expand(B, 1, D), h], dim=1)
        for i in range(self.depth):
            h = getattr(self, f"block{i}")(h, dt)
        h = self.norm(h, dt)
        return h[:, 1:].reshape(B, g, g, D).contiguous()


def dinov2_vits14(dtype=torch.float32) -> DinoV2ViT:
    return DinoV2ViT(dtype=dtype)


def vit_param_groups(modules: Iterable[str]) -> Dict[str, str]:
    """Optimizer group of each top-level backbone module (ref
    util/args.py:516-524): block 11 and the final norm -> 'train'; blocks
    9-10 -> 'freeze'; the rest -> 'backbone'."""
    groups = {}
    for name in modules:
        if name in ("block11", "norm"):
            groups[name] = "train"
        elif name in ("block9", "block10"):
            groups[name] = "freeze"
        else:
            groups[name] = "backbone"
    return groups
