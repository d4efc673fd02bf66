"""Class-hierarchy ``Node`` tree.

Behavioral counterpart of the reference's ``util/node.py:16-529`` ``Node``
class: a rooted tree over class names where every internal node owns a child
label mapping, leaf-descendant bookkeeping, per-node prototype budgets and
per-child class-balance loss weights.  This implementation is framework-free
(numpy only); all array material is derived from it by
``compile.compile_tree``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Set

import numpy as np


def split_value(total: int, parts: int) -> List[int]:
    """Split ``total`` into ``parts`` near-equal integers (ref util/node.py:9-14)."""
    q, r = divmod(total, parts)
    return [q + 1 if i < r else q for i in range(parts)]


class Node:
    """One node of the class hierarchy.

    Internal nodes (``num_children() > 0``) carry a prototype bank and a
    classifier over their children in the model; leaves are the fine classes.
    """

    def __init__(self, name: str, parent: Optional["Node"] = None, label: Optional[int] = None):
        self.parent = parent
        self.children: List[Node] = []
        self.children_to_labels: Dict[str, int] = {}
        self.name = name
        self.label = label
        self.weights: Optional[np.ndarray] = None
        self.num_protos: Optional[int] = None
        self.num_protos_per_child: Optional[Dict[str, int]] = None
        # filled by assign_all_descendents()
        self.descendents: Set[str] = set()
        self.leaf_descendents: Set[str] = set()
        self.leaf_descendents_of_child: Dict[str, Set[str]] = defaultdict(set)


    # -- lookup ------------------------------------------------------------
    def get_node(self, name: str) -> Optional["Node"]:
        """BFS search by name (ref util/node.py:111-123)."""
        active = [self]
        while active:
            for node in active:
                if node.name == name:
                    return node
            active = [c for node in active for c in node.children]
        return None

    def children_names(self) -> List[str]:
        return [c.name for c in self.children]

    # -- persistence -------------------------------------------------------
    @classmethod
    def from_dict(cls, d: dict, parent: Optional["Node"] = None) -> "Node":
        node = cls(d["name"], parent=parent, label=d.get("label"))
        for cd in d.get("children", []):
            child = cls.from_dict(cd, parent=node)
            node.children.append(child)
            node.children_to_labels[child.name] = child.label
        if parent is None:
            # budget assignment (set_num_protos) reads the descendant sets,
            # so the root rebuild must restore them like build.py:117 does
            node.assign_all_descendents()
        return node

    def num_children(self) -> int:
        return len(self.children)

    def is_leaf(self) -> bool:
        return self.num_children() == 0

    # -- traversal ---------------------------------------------------------
    def nodes_with_children(self) -> List["Node"]:
        """All internal nodes in BFS (level) order — the canonical node order
        used everywhere in the model (ref util/node.py:174-185)."""
        nodes: List[Node] = []
        active = [self]
        while active:
            nodes.extend(n for n in active if n.num_children() > 0)
            active = [c for node in active for c in node.children]
        return nodes

    # -- descendant bookkeeping --------------------------------------------
    def assign_descendents(self) -> None:
        descendents: Set[str] = set()
        active = list(self.children)
        while active:
            descendents.update(n.name for n in active)
            active = [c for node in active for c in node.children]
        self.descendents = descendents

    def assign_leaf_descendents(self) -> None:
        """Leaf descendants overall and per child (ref util/node.py:214-238).
        A leaf node maps to itself."""
        if self.is_leaf():
            self.leaf_descendents = {self.name}
            self.leaf_descendents_of_child = defaultdict(set)
            return
        leaf_descendents: Set[str] = set()
        per_child: Dict[str, Set[str]] = defaultdict(set)
        active = list(self.children)
        while active:
            for node in active:
                if node.is_leaf():
                    leaf_descendents.add(node.name)
                    per_child[self.closest_descendent_for(node.name).name].add(node.name)
            active = [c for node in active for c in node.children]
        self.leaf_descendents = leaf_descendents
        self.leaf_descendents_of_child = per_child

    def assign_all_descendents(self) -> None:
        active = [self]
        while active:
            for node in active:
                node.assign_descendents()
            active = [c for node in active for c in node.children]
        active = [self]
        while active:
            for node in active:
                node.assign_leaf_descendents()
            active = [c for node in active for c in node.children]

    def closest_descendent_for(self, name: str) -> "Node":
        """The child of this node whose subtree contains ``name``
        (ref util/node.py:282-286)."""
        if name in self.children_names():
            return self.get_node(name)
        return [c for c in self.children if name in c.descendents][0]

    def num_leaf_descendents(self) -> int:
        return len(self.leaf_descendents)

    # -- budgets & weights --------------------------------------------------
    def set_num_protos(self, num_protos_per_descendant: int, num_protos_per_child: int,
                       min_protos: int = 0, split_protos: bool = False) -> None:
        """Per-node prototype budget (ref util/node.py:43-71).

        With ``num_protos_per_child > 0`` (the flagship configs):
            P_node = sum over children of max(per_child, per_desc * child_leaves)
        Otherwise: P_node = max(min_protos, leaves * per_desc) and, when
        ``split_protos``, a per-child partition is recorded.
        """
        if num_protos_per_child > 0:
            self.num_protos_per_child = {}
            self.num_protos = 0
            for child in self.children:
                budget = max(num_protos_per_child,
                             num_protos_per_descendant * child.num_leaf_descendents())
                self.num_protos_per_child[child.name] = budget
                self.num_protos += budget
            return

        self.num_protos = max(min_protos, self.num_leaf_descendents() * num_protos_per_descendant)
        if not split_protos:
            raise NotImplementedError("non-split prototype budgets are not supported (ref util/node.py:70-71)")
        self.num_protos_per_child = {}
        if min_protos > self.num_leaf_descendents() * num_protos_per_descendant:
            parts = split_value(min_protos, self.num_children())
            for i, child in enumerate(self.children):
                self.num_protos_per_child[child.name] = parts[i]
        else:
            for child in self.children:
                self.num_protos_per_child[child.name] = (
                    len(self.leaf_descendents_of_child[child.name]) * num_protos_per_descendant)

    def set_loss_weightage_using_descendants_count(self) -> None:
        """Per-child class weights = min(desc counts)/desc_counts (ref util/node.py:37-41)."""
        counts = [len(self.leaf_descendents_of_child[c.name]) for c in self.children]
        self.weights = min(counts) / np.asarray(counts, dtype=np.float64)

    # -- joint-distribution naming ------------------------------------------
    # -- misc ----------------------------------------------------------------