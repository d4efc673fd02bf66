"""Compute ops: segment ops (plain PyTorch) and the hand-written CUDA
kernels with their plain versions (``fused_head``: K1)."""

from .segment import segment_max_to_nodes, segment_softmax

__all__ = ["segment_max_to_nodes", "segment_softmax"]
