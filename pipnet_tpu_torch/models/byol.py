"""BYOL: patch-level projector and predictor heads and the EMA target.

Counterpart of the JAX package's ``models/byol.py`` (itself the reference's
``pipnet_byol/pipnet_byol.py:35-160``): per-patch MLPs (D -> 3072 -> D with
BatchNorm and ReLU) on top of the backbone; the target branch is an
exponential moving average of the online backbone and projector, with a
cosine-scheduled tau (``pipnet/train.py:343-350``).  The target is a flat
dict of the port's parameter names (``backbone.*``, ``projector.*``) to
tensors, carried in the train state and checkpoints beside the model.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch
import torch.nn.functional as F
from torch import nn

from .resnet import BatchNorm

BYOL_HIDDEN = 3072
TARGET_PREFIXES = ("backbone.", "projector.")


class PatchMLP(nn.Module):
    """MLP over the patches of (B, H, W, D) features: D -> hidden -> D
    with BatchNorm and ReLU (flax ``Dense`` layers ``fc_in``/``fc_out``)."""

    def __init__(self, channels: int, hidden: int = BYOL_HIDDEN):
        super().__init__()
        self.fc_in = nn.Linear(channels, hidden)
        self.bn = BatchNorm(hidden)
        self.fc_out = nn.Linear(hidden, channels)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        dt = x.dtype
        h = F.linear(x, self.fc_in.weight.to(dt), self.fc_in.bias.to(dt))
        h = F.relu(self.bn(h, train))
        return F.linear(h, self.fc_out.weight.to(dt), self.fc_out.bias.to(dt))


def byol_tau_schedule(step: float, max_steps: float, tau_base: float = 0.9995,
                      tau_max: float = 1.0) -> float:
    """Cosine-ramped EMA coefficient (ref pipnet/train.py:344)."""
    cos = math.cos(math.pi * step / max(max_steps, 1.0))
    return tau_max - (tau_max - tau_base) * (cos + 1.0) / 2.0


@torch.no_grad()
def ema_update(target: Mapping[str, torch.Tensor], online: Mapping[str, torch.Tensor],
               tau: float) -> None:
    """target <- tau * target + (1 - tau) * online, in place, over the
    target's names (ref pipnet/train.py:39-42): one pass over the tree."""
    names = list(target)
    t = [target[n] for n in names]
    torch._foreach_mul_(t, tau)
    torch._foreach_add_(t, [online[n].detach() for n in names], alpha=1.0 - tau)


def init_byol_state(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The target branch as a copy of the online backbone and projector
    (ref pipnet_byol.py:73-76)."""
    return {n: p.detach().clone() for n, p in model.named_parameters()
            if n.startswith(TARGET_PREFIXES)}
