"""PIPNet: backbone + stacked prototype head, and the joint leaf decode.

Counterpart of the JAX package's ``models/pipnet.py`` (itself the reference
``PIPNet``, ``pipnet/pipnet.py:54-185``) for the serving slice: the ConvNeXt
backbones, the conv add-on head over K1, and the vectorized joint
distribution over leaves.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..device import resolve_device
from ..ops.segment import tree_tensor
from ..tree.compile import TreeArrays, compile_tree
from ..tree.node import Node
from .convnext import convnext_tiny_7, convnext_tiny_13, convnext_tiny_26
from .heads import PrototypeHead

BACKBONES = {
    "convnext_tiny_26": (convnext_tiny_26, 768),
    "convnext_tiny_13": (convnext_tiny_13, 768),
    "convnext_tiny_7": (convnext_tiny_7, 768),
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _unported(cfg: ModelConfig) -> list:
    return [name for name, on in (
        (f"backbone={cfg.backbone!r}", cfg.backbone not in BACKBONES),
        ("gaussian_stages", bool(cfg.gaussian_stages)),
        ("stage4_reducer", bool(cfg.stage4_reducer)),
        ("use_byol", cfg.use_byol),
        ("use_pallas_backbone (K4)", cfg.use_pallas_backbone)) if on]


class PIPNet(nn.Module):
    """Hierarchical prototype network over a compiled tree (inference)."""

    def __init__(self, tree: TreeArrays, cfg: ModelConfig):
        super().__init__()
        missing = _unported(cfg)
        if missing:
            raise NotImplementedError(
                f"model options {missing} are not ported yet; the serving "
                f"slice runs {sorted(BACKBONES)} with the conv prototype head")
        self.tree, self.cfg = tree, cfg
        self.dtype = _DTYPES[cfg.compute_dtype]
        ctor, channels = BACKBONES[cfg.backbone]
        self.backbone = ctor(dtype=self.dtype, fast_gelu=cfg.fast_gelu)
        self.head = PrototypeHead(tree, cfg.head, channels)

    def features(self, xs: torch.Tensor) -> torch.Tensor:
        return self.backbone(xs)

    def forward(self, xs: torch.Tensor, *, inference: bool = False,
                apply_overspecificity_mask: bool = False) -> Dict[str, torch.Tensor]:
        """xs (B, S, S, 3) -> {'features', 'proto_features', 'pooled',
        'logits'} with layouts (B,H,W,D), (B,H,W,P), (B,P), (B,C)."""
        f = self.features(xs)
        out = self.head(f, inference=inference,
                        apply_overspecificity_mask=apply_overspecificity_mask)
        out["features"] = f
        return out


# ----------------------------------------------------------------------------
# joint distribution over leaves
# ----------------------------------------------------------------------------

def leave_out_decode_tables(tree: TreeArrays, leave_out_idx) -> tuple:
    """Static tables implementing the reference's leave-out-class (LOU)
    short-circuit (``util/node.py:319-326``): at a node where ANY child's
    entire leaf set is left out, the whole subtree distribution is replaced by
    a deterministic indicator on that node's first left-out LEAF child.  The
    recursion is top-down, so only the TOPMOST triggering node on a leaf's
    root path applies.

    Returns ``(use_mask (L, N) f32, extra (L,) f32)``: a leaf's log joint is
    the sum of its path edges where ``use_mask`` is 1 plus ``extra``
    (0 for the chosen indicator leaf, -inf for other leaves under a trigger).
    """
    L, N = tree.leaf_under_node.shape
    lo = np.zeros(L, bool)
    lo[np.asarray(list(leave_out_idx), np.int64)] = True
    under = tree.leaf_under_node.astype(bool)                       # (L, N)
    child_leaf = tree.child_leaf_matrix.astype(bool)                # (L, C)

    trigger = np.zeros(N, bool)
    chosen = np.full(N, -1, np.int64)
    for ni in range(N):
        cs = tree.node_child_slice(ni)
        cols = np.arange(cs.start, cs.stop)
        full_out = [c for c in cols
                    if child_leaf[:, c].any() and lo[child_leaf[:, c]].all()]
        if not full_out:
            continue
        trigger[ni] = True
        leaf_cols = [c for c in cols
                     if tree.child_leaf_class[c] >= 0
                     and lo[tree.child_leaf_class[c]]]
        if not leaf_cols:
            raise ValueError(
                f"node {tree.node_names[ni]}: an internal child subtree is "
                "fully left out but no direct leaf child is left out — the "
                "reference decode is undefined here (util/node.py:319-326)")
        chosen[ni] = int(tree.child_leaf_class[leaf_cols[0]])

    # depth = number of strict ancestors (nodes with a strict leafset superset)
    sizes = under.sum(axis=0)
    depth = np.zeros(N, np.int64)
    for n in range(N):
        for m in range(N):
            if m != n and sizes[m] > sizes[n] and not (under[:, n] & ~under[:, m]).any():
                depth[n] += 1

    use = under.copy()
    extra = np.zeros(L, np.float32)
    for leaf in range(L):
        path = np.flatnonzero(under[leaf])
        trig = [n for n in path if trigger[n]]
        if not trig:
            continue
        top = min(trig, key=lambda n: depth[n])
        for n in path:
            if depth[n] >= depth[top]:
                use[leaf, n] = False        # T's edge and everything below
        extra[leaf] = 0.0 if leaf == chosen[top] else -np.inf
    return use.astype(np.float32), extra


def _child_columns(tree: TreeArrays) -> np.ndarray:
    """(N, Cmax) global child column per (node, child slot), -1 past the end."""
    cols = np.full((tree.num_nodes, tree.max_children), -1, np.int64)
    for ni in range(tree.num_nodes):
        cn = int(tree.node_num_children[ni])
        cols[ni, :cn] = np.arange(tree.node_child_offset[ni],
                                  tree.node_child_offset[ni] + cn)
    return cols


def _leaf_count_prior(tree: TreeArrays) -> np.ndarray:
    """(N, Cmax) log leaf-count prior per child slot (degenerate nodes)."""
    prior = np.zeros((tree.num_nodes, tree.max_children), np.float32)
    for ni in range(tree.num_nodes):
        cn = int(tree.node_num_children[ni])
        counts = tree.child_num_leaves[
            tree.node_child_offset[ni]: tree.node_child_offset[ni] + cn]
        prior[ni, :cn] = np.log(counts / counts.sum())
    return prior


def joint_leaf_log_distribution(logits: torch.Tensor, tree: TreeArrays,
                                softmax_tau: float = 1.0,
                                degenerate_nodes=None,
                                leave_out_idx=None) -> torch.Tensor:
    """Log joint distribution over the fine classes, (B, C) -> (B, L).

    Vectorized form of the reference's recursive
    ``distribution_over_furthest_descendents`` (``util/node.py:300-395``):
    at every node, child probabilities are ``softmax(log1p(out^2)/tau)``; a
    leaf's joint probability is the product along its root-to-leaf path:

        logp[leaf] = sum over nodes n with leaf under n of
                     log_softmax_n(log1p(out_n^2)/tau)[child_col(leaf, n)]

    Classes are ordered by sorted name.  ``degenerate_nodes`` (N,) bool falls
    back to leaf-count priors at those nodes (ref util/node.py:336-361);
    ``leave_out_idx`` applies the LOU short-circuit
    (``leave_out_decode_tables``).
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

    if degenerate_nodes is not None:
        prior = tree_tensor(tree, "decode_prior", _leaf_count_prior(tree), dev,
                            logp_children.dtype)
        deg = torch.as_tensor(np.asarray(degenerate_nodes), device=dev).reshape(1, -1, 1)
        logp_children = torch.where(deg, prior[None], logp_children)

    slot = tree_tensor(tree, "decode_slot",
                       np.where(tree.leaf_child_slot >= 0, tree.leaf_child_slot, 0),
                       dev, torch.long)                               # (L, N)
    if leave_out_idx is not None and len(leave_out_idx) > 0:
        use_np, extra_np = leave_out_decode_tables(tree, leave_out_idx)
        under = torch.as_tensor(use_np, device=dev) > 0
        extra = torch.as_tensor(extra_np, device=dev)[None]
    else:
        under = tree_tensor(tree, "decode_under", tree.leaf_under_node, dev, torch.bool)
        extra = 0.0
    node = torch.arange(tree.num_nodes, device=dev)[None, :].expand_as(slot)
    g = logp_children[:, node, slot]                                  # (B, L, N)
    g = torch.where(under[None], g, torch.zeros_like(g))
    return g.sum(dim=-1) + extra


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


def build_pipnet(root: Node, cfg: ModelConfig, *, weighted: bool = False,
                 class_names: Sequence[str] = None,
                 device: Union[str, torch.device] = "cuda") -> Tuple[PIPNet, TreeArrays]:
    """Budget the tree, compile it, and construct the model on ``device``
    (the card unless the caller asks for the CPU).  Parameters come from a
    checkpoint (``run_io.load_run``) or ``models/convert.py``."""
    dev = resolve_device(device)
    assign_prototype_budgets(root, cfg)
    tree = compile_tree(root, class_names=class_names,
                        protopool=cfg.head.protopool, weighted=weighted)
    return PIPNet(tree, cfg).to(dev).eval(), tree


def latent_shape(cfg: ModelConfig) -> Tuple[int, int]:
    """Static latent (H, W) for an image_size (ConvNeXt backbones)."""
    s = cfg.image_size
    if not cfg.backbone.startswith("convnext"):
        raise NotImplementedError(f"backbone {cfg.backbone!r} is not ported yet")
    s4 = s // 4
    if cfg.backbone.endswith("_26"):
        h = (s4 - 2) // 2 + 1   # down1 stride 2
        h = h - 1               # down2 stride 1, k2 VALID
        h = h - 1               # down3 stride 1
    elif cfg.backbone.endswith("_13"):
        h = (s4 - 2) // 2 + 1
        h = (h - 2) // 2 + 1
        h = h - 1
    else:
        h = s // 32
    return (h, h)
