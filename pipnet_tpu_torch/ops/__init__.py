"""Compute ops: segment ops (plain PyTorch) and the hand-written CUDA
kernels with their plain versions (``fused_head``: K1 and its adjoint K1b;
``fused_head_nopf``: K2; ``dwconv``: K3; ``cnblock``: K4; ``uniform_pairs``:
K5 and its gradient K5b, the uniformity loss's pair sum)."""

from .cnblock import (FusedCNBlock, cnblock_branch, cnblock_branch_reference,
                      cnblock_branch_unfused)
from .dwconv import DwConv7x7, dwconv7x7, dwconv7x7_reference, dwconv7x7_weight_grad
from .segment import (segment_hard_gumbel, segment_max_to_nodes, segment_softmax,
                      segment_sum_to_nodes, soft_gumbel)

__all__ = ["DwConv7x7", "FusedCNBlock", "cnblock_branch", "cnblock_branch_reference",
           "cnblock_branch_unfused", "dwconv7x7", "dwconv7x7_reference",
           "dwconv7x7_weight_grad", "segment_hard_gumbel", "segment_max_to_nodes",
           "segment_softmax", "segment_sum_to_nodes", "soft_gumbel"]
