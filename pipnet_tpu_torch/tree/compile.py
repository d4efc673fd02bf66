"""Tree -> static arrays ("tree compiler").

The reference loops over ``root.nodes_with_children()`` in Python inside
``forward`` and the loss (``pipnet/pipnet.py:124-170``); here the tree is
*compiled once* into frozen index arrays and masks so that every per-node
computation becomes one batched tensor op over a stacked prototype axis:

* all nodes' prototype banks are concatenated into one ``P``-wide axis
  (one 1x1 conv / matmul feeds every node at once);
* nodes are grouped into *buckets* of equal padded width so per-node softmax /
  max-pool are dense ``reshape -> reduce`` ops with no raggedness;
* all nodes' classifiers are concatenated into one ``C``-wide axis with a
  static block mask (block-diagonal masked matmul);
* all label machinery (which child of which node a fine class belongs to)
  becomes int32 lookup tables indexed by the fine label.

Everything here is plain numpy computed once at model-build time.  This is
the port's own copy of the JAX package's tree compiler: both must produce
the same arrays field by field (``tests/test_torch_tree.py``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .node import Node


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A group of consecutive nodes sharing one padded prototype width.

    The slice ``[proto_offset, proto_offset + num_nodes*width)`` of the stacked
    prototype axis reshapes to ``(num_nodes, width)``.
    """
    node_start: int      # first node index (in compiled node order)
    num_nodes: int
    width: int           # padded per-node prototype count
    proto_offset: int    # start of this bucket's slice in the P axis


@dataclasses.dataclass
class TreeArrays:
    """Frozen array form of a class hierarchy (see module docstring)."""

    # naming
    node_names: List[str]            # N internal nodes (bucket-sorted order)
    class_names: List[str]           # L fine classes, sorted (= ImageFolder label order)
    child_names: List[str]           # C child slots, grouped by node

    # prototype axis (length P = total padded prototypes)
    num_protos_padded: int
    proto_node: np.ndarray           # (P,) int32, node idx or -1 for padding
    proto_valid: np.ndarray          # (P,) bool
    proto_child_slot: np.ndarray     # (P,) int32 child slot within node (protopool='n' partition), -1 otherwise
    proto_child_col: np.ndarray      # (P,) int32 global child column, -1 otherwise
    node_proto_offset: np.ndarray    # (N,) int32 start of node's slice
    node_num_protos: np.ndarray      # (N,) int32 true P_n
    node_proto_width: np.ndarray     # (N,) int32 padded width (= bucket width)
    buckets: List[Bucket]

    # classifier axis (length C = sum of children over nodes)
    num_children_total: int
    child_node: np.ndarray           # (C,) int32 node idx of each child column
    node_child_offset: np.ndarray    # (N,) int32
    node_num_children: np.ndarray    # (N,) int32
    max_children: int
    class_mask: np.ndarray           # (C, P) f32: 1 where proto belongs to column's node
    child_block_mask: np.ndarray     # (C, P) f32: 1 where proto belongs to column's child partition
    child_is_leaf: np.ndarray        # (C,) bool
    child_leaf_class: np.ndarray     # (C,) int32 class idx if the child is a leaf else -1
    child_num_leaves: np.ndarray     # (C,) int32 leaf-descendant count of the child
    node_weights: np.ndarray         # (C,) f32 per-child class-balance loss weight (1.0 when unweighted)

    # label machinery (L fine classes)
    leaf_child_slot: np.ndarray      # (L, N) int32, -1 when class not under node
    leaf_child_col: np.ndarray       # (L, N) int32 global column, -1 when absent
    leaf_under_node: np.ndarray      # (L, N) bool
    child_leaf_matrix: np.ndarray    # (L, C) f32: 1 iff leaf is a descendant of child column
    node_num_leaves: np.ndarray      # (N,) int32

    # -- derived helpers ----------------------------------------------------
    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_classes(self) -> int:
        return len(self.class_names)

    def node_index(self, name: str) -> int:
        return self.node_names.index(name)

    def node_proto_slice(self, node_idx: int) -> slice:
        off = int(self.node_proto_offset[node_idx])
        return slice(off, off + int(self.node_num_protos[node_idx]))

    def node_child_slice(self, node_idx: int) -> slice:
        off = int(self.node_child_offset[node_idx])
        return slice(off, off + int(self.node_num_children[node_idx]))

    def summary(self) -> str:
        used = int(self.proto_valid.sum())
        return (f"TreeArrays: {self.num_nodes} nodes, {self.num_classes} classes, "
                f"{used} prototypes in {self.num_protos_padded} padded slots "
                f"({len(self.buckets)} buckets, waste {self.num_protos_padded / max(used,1):.2f}x), "
                f"{self.num_children_total} child columns")


def compile_tree(root: Node,
                 class_names: Optional[Sequence[str]] = None,
                 *,
                 protopool: bool = True,
                 weighted: bool = False,
                 pad_total_to: int = 128,
                 max_buckets: int = 16) -> TreeArrays:
    """Compile a budgeted ``Node`` tree into ``TreeArrays``.

    ``root`` must already have descendants assigned and ``set_num_protos``
    called on every internal node.  ``class_names`` defaults to the sorted leaf
    names (identical to torchvision ImageFolder label order, which sorts class
    directory names — ref util/data.py:656-658).

    ``protopool=False`` records the per-child prototype partition that the
    reference realizes by initializing off-block classifier weights to -0.5
    (``pipnet/pipnet.py:1235-1248``); here it is a static block mask instead.
    ``weighted`` fills ``node_weights`` with descendant-count balance weights
    (ref util/node.py:37-41, enabled by ``--weighted_ce_loss``), else ones.
    """
    nodes = root.nodes_with_children()
    if any(n.num_protos is None for n in nodes):
        raise ValueError("call set_num_protos on every internal node before compiling")

    if class_names is None:
        class_names = sorted(leaf.name for leaf in root.leaves())
    class_names = list(class_names)
    class_to_idx = {name: i for i, name in enumerate(class_names)}
    L = len(class_names)

    # ---- bucket the nodes by padded prototype width -----------------------
    widths = sorted({int(n.num_protos) for n in nodes})
    if len(widths) > max_buckets:
        # merge into power-of-two-ish size classes to bound kernel count
        def pad_width(p: int) -> int:
            w = 8
            while w < p:
                w *= 2
            return w
    else:
        def pad_width(p: int) -> int:
            return int(p)

    order = sorted(range(len(nodes)), key=lambda i: (pad_width(int(nodes[i].num_protos)),
                                                     int(nodes[i].num_protos), i))
    nodes = [nodes[i] for i in order]
    N = len(nodes)
    node_names = [n.name for n in nodes]

    buckets: List[Bucket] = []
    node_proto_offset = np.zeros(N, np.int32)
    node_num_protos = np.asarray([int(n.num_protos) for n in nodes], np.int32)
    node_proto_width = np.asarray([pad_width(int(n.num_protos)) for n in nodes], np.int32)

    offset = 0
    i = 0
    while i < N:
        w = int(node_proto_width[i])
        j = i
        while j < N and int(node_proto_width[j]) == w:
            node_proto_offset[j] = offset + (j - i) * w
            j += 1
        buckets.append(Bucket(node_start=i, num_nodes=j - i, width=w, proto_offset=offset))
        offset += (j - i) * w
        i = j
    P = _round_up(offset, pad_total_to) if pad_total_to > 1 else offset

    proto_node = np.full(P, -1, np.int32)
    proto_valid = np.zeros(P, bool)
    proto_child_slot = np.full(P, -1, np.int32)

    # ---- classifier columns ------------------------------------------------
    node_child_offset = np.zeros(N, np.int32)
    node_num_children = np.asarray([n.num_children() for n in nodes], np.int32)
    node_child_offset[1:] = np.cumsum(node_num_children)[:-1]
    C = int(node_num_children.sum())
    child_names: List[str] = []
    child_node = np.zeros(C, np.int32)
    child_is_leaf = np.zeros(C, bool)
    child_leaf_class = np.full(C, -1, np.int32)
    child_num_leaves = np.zeros(C, np.int32)
    node_weights = np.ones(C, np.float32)
    node_num_leaves = np.asarray([n.num_leaf_descendents() for n in nodes], np.int32)

    leaf_child_slot = np.full((L, N), -1, np.int32)
    leaf_child_col = np.full((L, N), -1, np.int32)
    child_leaf_matrix = np.zeros((L, C), np.float32)

    for ni, node in enumerate(nodes):
        # prototype slots + per-child partition
        off = int(node_proto_offset[ni])
        pn = int(node_num_protos[ni])
        proto_node[off:off + pn] = ni
        proto_valid[off:off + pn] = True
        if not protopool:
            if node.num_protos_per_child is None:
                raise ValueError(f"node {node.name}: per-child budgets missing for protopool='n'")
            start = off
            # child partition order follows node.children order, matching the
            # reference's sequential start_idx walk (pipnet/pipnet.py:1237-1246)
            for child in node.children:
                cnt = int(node.num_protos_per_child[child.name])
                slot = node.children_to_labels[child.name]
                proto_child_slot[start:start + cnt] = slot
                start += cnt
            if start != off + pn:
                raise ValueError(f"node {node.name}: per-child budgets do not sum to num_protos")

        # child columns are ordered by child label (slot), so column index ==
        # node_child_offset + children_to_labels[name]
        coff = int(node_child_offset[ni])
        slot_to_child = {node.children_to_labels[c.name]: c for c in node.children}
        if weighted:
            node.set_loss_weightage_using_descendants_count()
        for slot in range(node.num_children()):
            child = slot_to_child[slot]
            col = coff + slot
            child_names.append(child.name)
            child_node[col] = ni
            child_is_leaf[col] = child.is_leaf()
            leaf_set = node.leaf_descendents_of_child[child.name] if not child.is_leaf() else {child.name}
            child_num_leaves[col] = len(leaf_set)
            if child.is_leaf() and child.name in class_to_idx:
                child_leaf_class[col] = class_to_idx[child.name]
            if weighted:
                node.weights = np.asarray(node.weights)
                node_weights[col] = node.weights[slot]
            for leaf in leaf_set:
                if leaf in class_to_idx:
                    li = class_to_idx[leaf]
                    leaf_child_slot[li, ni] = slot
                    leaf_child_col[li, ni] = col
                    child_leaf_matrix[li, col] = 1.0

    proto_child_col = np.where(
        proto_child_slot >= 0,
        np.where(proto_node >= 0, node_child_offset[np.clip(proto_node, 0, N - 1)], 0) + proto_child_slot,
        -1).astype(np.int32)

    leaf_under_node = leaf_child_slot >= 0

    # block masks for the stacked classifier
    class_mask = np.zeros((C, P), np.float32)
    child_block_mask = np.zeros((C, P), np.float32)
    for ni in range(N):
        ps = slice(int(node_proto_offset[ni]), int(node_proto_offset[ni]) + int(node_num_protos[ni]))
        cs = slice(int(node_child_offset[ni]), int(node_child_offset[ni]) + int(node_num_children[ni]))
        class_mask[cs, ps] = 1.0
        if protopool:
            child_block_mask[cs, ps] = 1.0
    if not protopool:
        for p in range(P):
            if proto_child_col[p] >= 0:
                child_block_mask[proto_child_col[p], p] = 1.0

    return TreeArrays(
        node_names=node_names, class_names=class_names, child_names=child_names,
        num_protos_padded=P, proto_node=proto_node, proto_valid=proto_valid,
        proto_child_slot=proto_child_slot, proto_child_col=proto_child_col,
        node_proto_offset=node_proto_offset, node_num_protos=node_num_protos,
        node_proto_width=node_proto_width, buckets=buckets,
        num_children_total=C, child_node=child_node,
        node_child_offset=node_child_offset, node_num_children=node_num_children,
        max_children=int(node_num_children.max()) if N else 0,
        class_mask=class_mask, child_block_mask=child_block_mask,
        child_is_leaf=child_is_leaf, child_leaf_class=child_leaf_class,
        child_num_leaves=child_num_leaves, node_weights=node_weights,
        leaf_child_slot=leaf_child_slot, leaf_child_col=leaf_child_col,
        leaf_under_node=leaf_under_node, child_leaf_matrix=child_leaf_matrix,
        node_num_leaves=node_num_leaves,
    )


def flat_tree(class_names: Sequence[str], num_protos: int) -> Node:
    """A single-level tree: root with every class as a leaf child.

    This is the original flat PIP-Net configuration (the reference realizes it
    with a "flat-structure" phylogeny file, e.g. configs/cub18_flat.yaml).
    """
    root = Node("root")
    root.add_children(sorted(class_names))
    root.assign_all_descendents()
    root.num_protos = num_protos
    root.num_protos_per_child = None
    return root
