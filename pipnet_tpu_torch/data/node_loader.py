"""Node-scoped label remapping (counterpart of ``ModifiedLabelLoader``,
util/data.py:77-123): restrict a loader to one tree node's leaf descendants
and remap fine labels to the node's child ("coarsest") labels."""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

from ..tree.compile import TreeArrays
from .loader import Batch, Loader


class NodeFilteredLoader:
    """Yields (batch, orig_labels, node_child_labels) for samples under one
    node.  Uses the compiled LUT instead of per-batch name comparisons."""

    def __init__(self, loader: Loader, tree: TreeArrays, node: int):
        self.loader = loader
        self.tree = tree
        self.node = node
        # fine label -> child slot at this node (-1 = not under node)
        self.fine_to_slot = tree.leaf_child_slot[:, node]
        self.kept_classes = [tree.class_names[li]
                             for li in np.nonzero(self.fine_to_slot >= 0)[0]]

    def __iter__(self) -> Iterator[Tuple[Batch, np.ndarray, np.ndarray]]:
        for batch in self.loader.epoch(0):
            keep = self.fine_to_slot[batch.ys] >= 0
            if not keep.any():
                continue
            ys = batch.ys[keep]
            yield (Batch(xs1=batch.xs1[keep],
                         xs2=batch.xs2[keep] if batch.xs2 is not None else None,
                         ys=ys),
                   ys, self.fine_to_slot[ys])
