"""The HComP-Net loss catalog and its phase-weighted total."""

from .aggregate import LossWeights, compute_total_loss, resolve_tanh_eps
from .catalog import TreeConsts, make_tree_consts

__all__ = ["LossWeights", "compute_total_loss", "resolve_tanh_eps", "TreeConsts",
           "make_tree_consts"]
