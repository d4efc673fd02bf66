"""Compute ops: segment ops (plain PyTorch) and the hand-written CUDA
kernels with their plain versions (``fused_head``: K1 and its adjoint K1b;
``fused_head_nopf``: K2)."""

from .segment import (segment_max_to_nodes, segment_softmax, segment_sum_to_nodes,
                      soft_gumbel)

__all__ = ["segment_max_to_nodes", "segment_softmax", "segment_sum_to_nodes",
           "soft_gumbel"]
