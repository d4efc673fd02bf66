"""Evaluation metrics: top-k accuracy, sparsity statistics, per-node F1,
OOD detection.

The port's copy of the JAX package's ``eval/metrics.py`` (numpy only, the
same functions and the same numbers), the counterparts of the legacy flat
eval (``pipnet/test.py:12-292``: top-1/5, abstain count, global/local size
sparsity, the FPR95 OOD check) and the per-node accuracy/F1 bookkeeping in
the hierarchical trainer (``pipnet/train.py:469-475``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


def topk_accuracy(scores: np.ndarray, ys: np.ndarray,
                  ks: Sequence[int] = (1, 5)) -> Dict[int, float]:
    """(ref util/func.py:13-31; k capped at the class count)."""
    order = np.argsort(-scores, axis=-1)
    out = {}
    for k in ks:
        kk = min(k, scores.shape[-1])
        out[k] = float((order[:, :kk] == ys[:, None]).any(-1).mean())
    return out


def sparsity_stats(w_eff: np.ndarray, pooled: Optional[np.ndarray] = None,
                   threshold: float = 1e-3) -> Dict[str, float]:
    """Global/local explanation size (ref pipnet/test.py:85-96):

    * num_nonzero_prototypes: prototypes connected (> threshold) to any class;
    * global_size: total nonzero class-prototype connections;
    * local_size_mean: mean per-sample count of (pooled > threshold and
      weight > threshold) pairs over classes, i.e. evidence actually used.
    """
    nz_cols = (w_eff > threshold).any(axis=0)
    stats = {
        "num_nonzero_prototypes": int(nz_cols.sum()),
        "global_size": int((w_eff > threshold).sum()),
    }
    if pooled is not None:
        used = (pooled[:, None, :] > threshold) & (w_eff[None] > threshold)
        stats["local_size_mean"] = float(used.sum(axis=(1, 2)).mean())
    return stats


def pred_path_explanation_size(pooled: np.ndarray, w_eff: np.ndarray,
                               leaf_child_col: np.ndarray,
                               leaf_under_node: np.ndarray,
                               preds: np.ndarray,
                               threshold: float = 1e-3) -> Dict[str, float]:
    """Per-image explanation size of the PREDICTION — the hierarchical
    analog of the reference's per-predicted-class evidence count
    (``SimANZCC`` / ``correct_class_sim_scores_anz``, pipnet/test.py:56-62,
    the stat whose headline value is "tens" for a sparse PIP-Net head):
    (prototype, on-path child column) pairs whose EVIDENCE PRODUCT
    ``pooled * weight`` exceeds the threshold, summed over the predicted
    leaf's root->leaf path — the reference thresholds the product
    ``|pooled * weight| > 1e-3`` (pipnet/test.py:56-58), not the factors.
    ``local_size_mean`` (sparsity_stats) counts pairs over ALL child
    columns and so scales with the number of classes; this stat is what a
    user reads as "how many patches explain this prediction".

    Also returns ``almost_nonzeros_mean`` — the reference's ANZ
    (pipnet/test.py:64-65): mean per-image count of pooled > threshold
    (after the inference clamp, so effectively pooled > 0.1).
    """
    per_img = np.zeros(len(preds), np.float64)
    # group by predicted leaf: each group shares its few on-path columns, so
    # the product threshold runs on (B_leaf, path_len, P) slabs instead of a
    # full (B, C, P) tensor
    for leaf in np.unique(preds):
        cols = leaf_child_col[leaf][leaf_under_node[leaf]]
        cols = cols[cols >= 0]
        sel = preds == leaf
        prod = pooled[sel][:, None, :] * w_eff[cols][None, :, :]
        per_img[sel] = (prod > threshold).sum(axis=(1, 2))
    return {
        "local_size_pred_path_mean": float(per_img.mean()),
        "almost_nonzeros_mean": float((pooled > threshold).sum(axis=1).mean()),
    }


def abstained_count(scores: np.ndarray) -> int:
    """Images where the top class score is 0 (ref pipnet/test.py:66-70)."""
    return int((scores.max(axis=-1) <= 0.0).sum())


def per_node_prf(node_preds: np.ndarray, node_gts: np.ndarray,
                 num_children: int) -> Dict[str, float]:
    """Weighted precision/recall/F1 over one node's children (the reference
    uses torchmetrics weighted F1, pipnet/train.py:471)."""
    f1s, weights = [], []
    for c in range(num_children):
        tp = int(((node_preds == c) & (node_gts == c)).sum())
        fp = int(((node_preds == c) & (node_gts != c)).sum())
        fn = int(((node_preds != c) & (node_gts == c)).sum())
        prec = tp / (tp + fp) if tp + fp else 0.0
        rec = tp / (tp + fn) if tp + fn else 0.0
        f1 = 2 * prec * rec / (prec + rec) if prec + rec else 0.0
        f1s.append(f1)
        weights.append(int((node_gts == c).sum()))
    weights = np.asarray(weights, np.float64)
    if weights.sum() == 0:
        return {"f1": 0.0, "accuracy": 0.0}
    f1 = float((np.asarray(f1s) * weights).sum() / weights.sum())
    acc = float((node_preds == node_gts).mean()) if len(node_gts) else 0.0
    return {"f1": f1, "accuracy": acc}


def ood_id_fraction(scores_id: np.ndarray, scores_ood: np.ndarray,
                    threshold: float) -> Dict[str, float]:
    """OOD detection by max-score thresholding (ref pipnet/test.py:242-292):
    fraction of samples whose top score clears the class threshold."""
    return {
        "id_fraction_in_distribution": float((scores_id.max(-1) >= threshold).mean()),
        "id_fraction_ood": float((scores_ood.max(-1) >= threshold).mean()),
    }


def fpr95_threshold(scores: np.ndarray, ys: np.ndarray) -> float:
    """Score threshold at 95% true-positive rate over correct predictions
    (ref get_thresholds, pipnet/test.py:152-239, simplified to the global
    variant)."""
    pred = scores.argmax(-1)
    correct_scores = scores.max(-1)[pred == ys]
    if len(correct_scores) == 0:
        return 0.0
    return float(np.quantile(correct_scores, 0.05))


def degenerate_nodes_from_mask(tree, w_eff: np.ndarray,
                               presence_keep: np.ndarray,
                               threshold: float = 1e-3) -> np.ndarray:
    """(N,) bool: node has a child class whose masked classifier row keeps no
    prototype above ``threshold`` (ref util/node.py:336-347: such nodes fall
    back to leaf-count priors in the joint distribution)."""
    masked = w_eff * presence_keep[None, :]
    out = np.zeros(tree.num_nodes, bool)
    for ni in range(tree.num_nodes):
        cs = tree.node_child_slice(ni)
        rows = masked[cs]
        out[ni] = bool((rows.max(axis=1) <= threshold).any())
    return out


def per_class_fpr95_thresholds(scores: np.ndarray, ys: np.ndarray,
                               num_classes: int) -> np.ndarray:
    """Per-class score thresholds at 95% TPR over correctly-predicted samples
    (ref get_thresholds, pipnet/test.py:152-239).  Classes with no correct
    predictions inherit the global threshold."""
    pred = scores.argmax(-1)
    maxs = scores.max(-1)
    global_thr = fpr95_threshold(scores, ys)
    out = np.full(num_classes, global_thr, np.float64)
    for c in range(num_classes):
        sel = (pred == ys) & (ys == c)
        if sel.any():
            out[c] = np.quantile(maxs[sel], 0.05)
    return out


def eval_ood(scores_id: np.ndarray, ys_id: np.ndarray, scores_ood: np.ndarray,
             num_classes: int) -> Dict[str, float]:
    """OOD detection summary (ref eval_ood, pipnet/test.py:242-292): fraction
    of ID/OOD samples whose top joint score clears the mean per-class
    FPR95 threshold."""
    thr = per_class_fpr95_thresholds(scores_id, ys_id, num_classes)
    return {
        "threshold_mean": float(thr.mean()),
        **ood_id_fraction(scores_id, scores_ood, float(thr.mean())),
    }
