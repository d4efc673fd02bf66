"""The HComP-Net loss catalog and its phase-weighted total."""

from .aggregate import LossWeights, compute_total_loss, resolve_tanh_eps
from .catalog import (ALIGN_EPS, EPS, TreeConsts, align_and_uniform, align_loss_unit_space,
                      align_pf_loss, classification_loss, kernel_orth_loss, l2_normalize,
                      make_tree_consts, min_contrast_loss, overspecificity_losses,
                      tanh_desc_loss, tanh_loss, uniform_loss)

__all__ = [
    "LossWeights", "compute_total_loss", "resolve_tanh_eps", "TreeConsts",
    "make_tree_consts", "align_and_uniform", "align_loss_unit_space", "align_pf_loss",
    "classification_loss", "kernel_orth_loss", "l2_normalize", "min_contrast_loss",
    "overspecificity_losses", "tanh_desc_loss", "tanh_loss", "uniform_loss", "EPS",
    "ALIGN_EPS",
]
