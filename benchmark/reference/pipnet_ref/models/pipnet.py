"""PIPNet: backbone + stacked prototype head, and the joint leaf decode.

Counterpart of the JAX package's ``models/pipnet.py`` (itself the reference
``PIPNet``, ``pipnet/pipnet.py:54-185``), cut to what the benchmark's cells
run: the eager ConvNeXt-tiny-26, the prototype head's plain composition,
and the vectorized joint distribution over leaves.  A configuration that
asks for anything else (another backbone, the fused backbone, the Gaussian
multiplier, the stage-4 reducer, BYOL) raises.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..ops.segment import tree_tensor
from ..tree.compile import TreeArrays
from ..tree.node import Node
from .convnext import convnext_tiny_26
from .heads import PrototypeHead

BACKBONES = {
    "convnext_tiny_26": (convnext_tiny_26, 768),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PIPNet(nn.Module):
    """Hierarchical prototype network over a compiled tree."""

    def __init__(self, tree: TreeArrays, cfg: ModelConfig):
        super().__init__()
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"the reference holds only {list(BACKBONES)}, not {cfg.backbone}")
        unsupported = [name for name, on in (
            ("use_pallas_backbone", cfg.use_pallas_backbone),
            ("gaussian_stages", bool(cfg.gaussian_stages)),
            ("stage4_reducer", bool(cfg.stage4_reducer)),
            ("use_byol", cfg.use_byol)) if on]
        if unsupported:
            raise ValueError(f"the reference does not hold {unsupported}")
        self.tree, self.cfg = tree, cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        ctor, channels = BACKBONES[cfg.backbone]
        self.backbone = ctor(dtype=self.dtype, fast_gelu=cfg.fast_gelu)
        self.head = PrototypeHead(tree, cfg.head, channels)

    def features(self, xs: torch.Tensor, *, train: bool = False,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return self.backbone(xs, train=train, generator=generator)

    def forward(self, xs: torch.Tensor, *, train: bool = False,
                generator: Optional[torch.Generator] = None,
                inference: bool = False) -> Dict[str, torch.Tensor]:
        """xs (B, S, S, 3) -> {'features', 'proto_features', 'pooled',
        'logits'} with layouts (B,H,W,D), (B,H,W,P), (B,P), (B,C).  ``train``
        turns stochastic depth on, drawing from ``generator``;
        ``inference`` thresholds pooled."""
        f = self.features(xs, train=train, generator=generator)
        out = self.head(f, inference=inference)
        out["features"] = f
        return out


# ----------------------------------------------------------------------------
# joint distribution over leaves
# ----------------------------------------------------------------------------

def _child_columns(tree: TreeArrays) -> np.ndarray:
    """(N, Cmax) global child column per (node, child slot), -1 past the end."""
    cols = np.full((tree.num_nodes, tree.max_children), -1, np.int64)
    for ni in range(tree.num_nodes):
        cn = int(tree.node_num_children[ni])
        cols[ni, :cn] = np.arange(tree.node_child_offset[ni],
                                  tree.node_child_offset[ni] + cn)
    return cols


def joint_leaf_log_distribution(logits: torch.Tensor, tree: TreeArrays,
                                softmax_tau: float = 1.0) -> torch.Tensor:
    """Log joint distribution over the fine classes, (B, C) -> (B, L).

    Vectorized form of the reference's recursive
    ``distribution_over_furthest_descendents`` (``util/node.py:300-395``):
    at every node, child probabilities are ``softmax(log1p(out^2)/tau)``; a
    leaf's joint probability is the product along its root-to-leaf path:

        logp[leaf] = sum over nodes n with leaf under n of
                     log_softmax_n(log1p(out_n^2)/tau)[child_col(leaf, n)]

    Classes are ordered by sorted name.
    """
    dev = logits.device
    C = logits.shape[1]
    cols = _child_columns(tree)
    z = torch.log1p(logits ** 2) / softmax_tau
    idx = tree_tensor(tree, "decode_cols", np.clip(cols, 0, C - 1), dev, torch.long)
    valid = tree_tensor(tree, "decode_valid", cols >= 0, dev, torch.bool)
    zc = z[:, idx]                                                    # (B, N, Cmax)
    zc = torch.where(valid[None], zc, torch.full_like(zc, float("-inf")))
    logp_children = torch.log_softmax(zc, dim=-1)

    slot = tree_tensor(tree, "decode_slot",
                       np.where(tree.leaf_child_slot >= 0, tree.leaf_child_slot, 0),
                       dev, torch.long)                               # (L, N)
    under = tree_tensor(tree, "decode_under", tree.leaf_under_node, dev, torch.bool)
    node = torch.arange(tree.num_nodes, device=dev)[None, :].expand_as(slot)
    g = logp_children[:, node, slot]                                  # (B, L, N)
    g = torch.where(under[None], g, torch.zeros_like(g))
    return g.sum(dim=-1)


# ----------------------------------------------------------------------------
# construction helpers
# ----------------------------------------------------------------------------

def assign_prototype_budgets(root: Node, cfg: ModelConfig) -> None:
    """Apply the per-node budget rule of the reference's main.py:148-155."""
    if cfg.num_features == 0 and cfg.num_protos_per_descendant == 0 and cfg.num_protos_per_child == 0:
        raise ValueError("one of num_features / num_protos_per_descendant / num_protos_per_child must be > 0")
    for node in root.nodes_with_children():
        node.set_num_protos(num_protos_per_descendant=cfg.num_protos_per_descendant,
                            num_protos_per_child=cfg.num_protos_per_child,
                            min_protos=cfg.num_features,
                            split_protos=not cfg.head.protopool)
