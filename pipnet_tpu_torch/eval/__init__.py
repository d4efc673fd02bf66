"""Evaluation: metrics and joint-distribution decoding re-exports."""

from ..models.pipnet import joint_leaf_distribution, joint_leaf_log_distribution
from .metrics import (abstained_count, degenerate_nodes_from_mask, eval_ood,
                      fpr95_threshold, ood_id_fraction, per_class_fpr95_thresholds,
                      per_node_prf, pred_path_explanation_size, sparsity_stats,
                      topk_accuracy)

__all__ = [
    "joint_leaf_distribution", "joint_leaf_log_distribution",
    "abstained_count", "degenerate_nodes_from_mask", "eval_ood", "fpr95_threshold",
    "ood_id_fraction", "per_class_fpr95_thresholds", "per_node_prf",
    "pred_path_explanation_size", "sparsity_stats", "topk_accuracy",
]
