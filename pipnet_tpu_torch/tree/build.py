"""Phylogeny -> class-hierarchy ``Node`` tree construction.

Counterparts of the reference's ``util/phylo_utils.py:6-101``:

* ``construct_phylo_tree`` — full tree: internal nodes are named by joining the
  first "+"-segment of each child's name; single-child chains are collapsed.
* ``construct_discretized_phylo_tree`` — fixed-level tree cut at given relative
  phylogenetic distances; singular internal nodes are replaced by their first
  non-singular descendant (with label-map fixup).
"""

from __future__ import annotations

from typing import Optional

from .newick import TreeNode
from .node import Node
from .phylogeny import Phylogeny


def construct_phylo_tree(phylogeny_path: Optional[str] = None, *,
                         phylo: Optional[Phylogeny] = None) -> Node:
    """Build the full hierarchy from a Newick phylogeny (ref util/phylo_utils.py:64-101).

    Leaf names are expected in the ``<prefix>_<id>_<Species_Name>`` convention
    (e.g. ``cub_122_Harris_Sparrow``); internal node names become the
    "+"-joined child id prefixes (e.g. ``144+147``).
    """
    if phylo is None:
        phylo = Phylogeny(phylogeny_path)
    root = Node("root")

    def set_names(node: TreeNode) -> str:
        if node.is_leaf():
            return node.name.split("_")[1]
        child_names = [set_names(c) for c in node.get_children()]
        name = "+".join(n.split("+")[0] for n in child_names)
        if len(node.get_children()) > 1:
            node.name = name
        return name

    def build(parent: Node, enode: TreeNode) -> None:
        if enode.is_leaf() or len(enode.get_children()) > 1:
            parent.add_children(enode.name)
        if len(enode.get_children()) == 1:
            build(parent, enode.get_children()[0])
        if not enode.is_leaf() and len(enode.get_children()) > 1:
            node = parent.get_child(enode.name)
            for child in enode.get_children():
                build(node, child)

    tree_root = phylo.tree.get_tree_root()
    set_names(tree_root)
    for child in tree_root.get_children():
        build(root, child)
    return root


def construct_discretized_phylo_tree(phylogeny_path: Optional[str] = None,
                                     phylo_distances_string: str = "",
                                     *, phylo: Optional[Phylogeny] = None) -> Node:
    """Build a fixed-level hierarchy cut at relative distances
    (ref util/phylo_utils.py:6-62).

    ``phylo_distances_string`` e.g. ``'0.93,0.83,0.63'``: levels are the groups
    at relative distances ``1-d`` for reversed distances plus the leaf level.
    """
    if phylo is None:
        phylo = Phylogeny(phylogeny_path)
    root = Node("root")
    distances = [float(x) for x in phylo_distances_string.split(",")[::-1]] + [1]
    tag = "_lvl"

    lvl_groups = {}
    for lvl, dist in enumerate(distances):
        groups = phylo.get_species_groups(1 - dist)
        if lvl == len(distances) - 1:
            lvl_groups[lvl] = {g[0]: g for g in groups}
        else:
            lvl_groups[lvl] = {(g[0] + tag + str(lvl)): g for g in groups}
        if lvl == 0:
            root.add_children([rep for rep in lvl_groups[lvl]])
        else:
            prev_reps = list(lvl_groups[lvl - 1].keys())
            prev_to_children = {rep: [] for rep in prev_reps}
            for rep in lvl_groups[lvl]:
                for prev_rep in prev_reps:
                    if rep.split(tag)[0] in lvl_groups[lvl - 1][prev_rep]:
                        prev_to_children[prev_rep].append(rep)
                        break
            for prev_rep, children in prev_to_children.items():
                root.add_children_to(prev_rep, children)

    def get_nonsingular(node: Node) -> Node:
        if node.num_children() == 1:
            return get_nonsingular(node.children[0])
        return node

    # collapse singular internal nodes, fixing the child label maps
    for node in root.nodes_with_children():
        for i in range(len(node.children)):
            old = node.children[i]
            node.children[i] = get_nonsingular(node.children[i])
            if node.children[i] is not old:
                label = node.children_to_labels[old.name]
                del node.children_to_labels[old.name]
                node.children_to_labels[node.children[i].name] = label
    return root


def build_tree_from_config(phylogeny_path: str, phylo_distances_string: Optional[str]) -> Node:
    """Dispatch on discretization string like the reference's main.py:119-126."""
    if phylo_distances_string in (None, "", "None"):
        root = construct_phylo_tree(phylogeny_path)
    else:
        root = construct_discretized_phylo_tree(phylogeny_path, phylo_distances_string.replace(" ", ""))
    root.assign_all_descendents()
    return root
