"""Hierarchy subsystem: Newick parsing, Node trees, and the tree compiler
(numpy only)."""

from .newick import TreeNode, load_newick, parse_newick
from .node import Node, split_value
from .phylogeny import Phylogeny, PhylogenyCUB
from .build import (build_tree_from_config, construct_discretized_phylo_tree,
                    construct_phylo_tree)
from .compile import Bucket, TreeArrays, compile_tree, flat_tree

__all__ = [
    "TreeNode", "load_newick", "parse_newick",
    "Node", "split_value",
    "Phylogeny", "PhylogenyCUB",
    "build_tree_from_config", "construct_phylo_tree", "construct_discretized_phylo_tree",
    "Bucket", "TreeArrays", "compile_tree", "flat_tree",
]
