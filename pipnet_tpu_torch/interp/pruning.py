"""Post-hoc prototype pruning (the port's copy of the JAX package's
``interp/pruning.py``: numpy only, the same masks and report text).

Threshold pruning (``prune_by_threshold.ipynb`` cells 11-14): for every
prototype, compute the mean of its top-k activations over each relevant leaf
descendant's projection images; if ANY leaf's mean falls below the threshold
the prototype is overspecific -> zero its entire classifier column.

Mask pruning (``--mask_prune_overspecific`` at inference): drop prototypes
whose learned presence logits favor "absent" (hard Gumbel / argmax,
``pipnet/pipnet.py:164-166``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..tree.compile import TreeArrays
from .topk import ProjectionResult, topk_per_prototype_per_leaf


def prune_means(proj: ProjectionResult, tree: TreeArrays,
                w_eff: np.ndarray, *, topk: int = 10
                ) -> Dict[int, Dict[int, float]]:
    """Per-prototype, per-relevant-leaf mean of the top-k pooled activations
    (the pruning statistic of ``prune_by_threshold.ipynb`` cell 11) —
    threshold-independent, so a sweep computes it once."""
    per_leaf_topk = topk_per_prototype_per_leaf(proj, tree, w_eff, k=topk)
    return {p: {li: float(np.mean([s for _, s in entries]))
                for li, entries in leaf_map.items()}
            for p, leaf_map in per_leaf_topk.items() if leaf_map}


def apply_threshold_prune(means: Dict[int, Dict[int, float]],
                          tree: TreeArrays, cls_weight: np.ndarray,
                          *, threshold: float = 0.4,
                          include_leaf_parent_nodes: bool = False
                          ) -> np.ndarray:
    """Zero the classifier columns of prototypes whose top-k mean activation
    falls below ``threshold`` for ANY relevant leaf descendant.

    The reference prunes ONLY at nodes with at least one internal (non-leaf)
    child — its loop starts with ``if len(non_leaf_children_names) == 0:
    continue`` (prune_by_threshold.ipynb cell 11), so prototypes at
    leaf-parent nodes (the bulk of a binary phylogeny, and the ones doing
    the final species discrimination) are NEVER pruned.  Round 4 pruned
    them too, and top-1 collapsed 19.2% -> 4.0%; ``include_leaf_parent_nodes``
    keeps that non-reference behavior available for A/B."""
    new_w = np.array(cls_weight)
    for p, m in means.items():
        if not include_leaf_parent_nodes:
            ni = int(tree.proto_node[p])
            cs = tree.node_child_slice(ni)
            if bool(np.asarray(tree.child_is_leaf[cs]).all()):
                continue
        if any(v < threshold for v in m.values()):
            new_w[:, p] = 0.0
    return new_w


def threshold_prune(proj: ProjectionResult, tree: TreeArrays,
                    cls_weight: np.ndarray, w_eff: np.ndarray,
                    *, threshold: float = 0.4, topk: int = 10,
                    include_leaf_parent_nodes: bool = False
                    ) -> Tuple[np.ndarray, Dict[int, Dict[int, float]]]:
    """Returns (pruned classifier weight, per-proto per-leaf mean activations).

    ``cls_weight`` is the raw (C, P) parameter; ``w_eff`` the effective
    (relu+mask) weights used for relevance thresholds."""
    means = prune_means(proj, tree, w_eff, topk=topk)
    new_w = apply_threshold_prune(
        means, tree, cls_weight, threshold=threshold,
        include_leaf_parent_nodes=include_leaf_parent_nodes)
    return new_w, means


def presence_prune_mask(proto_presence: np.ndarray) -> np.ndarray:
    """Deterministic keep-mask from the learned presence logits: keep iff
    logit[p,1] > logit[p,0] (the argmax the hard Gumbel concentrates on)."""
    return (proto_presence[:, 1] > proto_presence[:, 0]).astype(np.float32)


def prototype_report(proj: ProjectionResult, tree: TreeArrays,
                     w_eff: np.ndarray, proto_presence: np.ndarray,
                     *, good_threshold: float = 0.2, topk: int = 10) -> str:
    """Per-node used/good prototype summary (the notebook's
    ``write_num_proto_details``): 'good' = mean top-k activation above
    ``good_threshold`` for EVERY relevant leaf descendant."""
    per_leaf_topk = topk_per_prototype_per_leaf(proj, tree, w_eff, k=topk)
    lines = []
    for ni, name in enumerate(tree.node_names):
        sl = tree.node_proto_slice(ni)
        protos = [p for p in range(sl.start, sl.stop) if p in per_leaf_topk]
        good = 0
        for p in protos:
            m = [np.mean([s for _, s in v]) for v in per_leaf_topk[p].values()]
            if m and all(x > good_threshold for x in m):
                good += 1
        keep = presence_prune_mask(proto_presence[sl])
        lines.append(f"Node:{name},Total:{sl.stop - sl.start},Used:{len(protos)},"
                     f"Good:{good},PresenceKeep:{int(keep.sum())}")
    return "\n".join(lines)
