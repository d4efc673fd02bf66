"""Minimal Newick tree parser (no ete3 dependency).

The reference stack parses phylogenies with ``ete3.PhyloTree(path, format=1)``
(``util/phylogeny.py:215,335`` in the reference).  This module provides a small,
dependency-free equivalent supporting the Newick features those trees use:
leaf names, internal node names, and branch lengths.

Grammar (informal):
    tree     := subtree ';'
    subtree  := leaf | '(' subtree (',' subtree)* ')' [name] [':' length]
    leaf     := name [':' length]

Quoted labels ('...') and whitespace are tolerated.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional


@dataclass
class TreeNode:
    """A parsed phylogenetic tree node (ete3.TreeNode work-alike subset)."""

    name: str = ""
    dist: float = 1.0
    children: List["TreeNode"] = field(default_factory=list)
    up: Optional["TreeNode"] = None

    # -- structure ---------------------------------------------------------
    def is_leaf(self) -> bool:
        return not self.children

    def get_children(self) -> List["TreeNode"]:
        return self.children

    def add_child(self, child: "TreeNode") -> "TreeNode":
        child.up = self
        self.children.append(child)
        return child

    def get_tree_root(self) -> "TreeNode":
        node = self
        while node.up is not None:
            node = node.up
        return node

    # -- traversal ---------------------------------------------------------
    def traverse(self, strategy: str = "preorder") -> Iterator["TreeNode"]:
        if strategy == "preorder":
            stack = [self]
            while stack:
                node = stack.pop()
                yield node
                stack.extend(reversed(node.children))
        elif strategy == "postorder":
            # iterative postorder keeping child order
            out: List[TreeNode] = []
            stack = [self]
            while stack:
                node = stack.pop()
                out.append(node)
                stack.extend(node.children)
            yield from reversed(out)
        elif strategy == "levelorder":
            queue = [self]
            while queue:
                node = queue.pop(0)
                yield node
                queue.extend(node.children)
        else:
            raise ValueError(f"unknown traversal strategy: {strategy}")

    def iter_leaves(self) -> Iterator["TreeNode"]:
        for node in self.traverse("preorder"):
            if node.is_leaf():
                yield node

    def get_leaves(self) -> List["TreeNode"]:
        return list(self.iter_leaves())

    def search_nodes(self, name: str) -> List["TreeNode"]:
        return [n for n in self.traverse("preorder") if n.name == name]

    # -- distances ---------------------------------------------------------
    def _path_to_root(self) -> List["TreeNode"]:
        path = [self]
        while path[-1].up is not None:
            path.append(path[-1].up)
        return path

    def get_distance(self, target, target2=None) -> float:
        """Branch-length distance between two nodes.

        ``root.get_distance(leaf)`` -> distance from self to ``target``;
        ``tree.get_distance(a, b)`` -> distance between ``a`` and ``b``.
        Mirrors the ete3 call patterns used by the reference
        (``util/phylogeny.py:236,264,276``).
        """
        if target2 is not None:
            a, b = target, target2
        else:
            a, b = self, target
        if isinstance(a, str):
            a = self.get_tree_root().search_nodes(a)[0]
        if isinstance(b, str):
            b = self.get_tree_root().search_nodes(b)[0]
        pa = a._path_to_root()
        pb = b._path_to_root()
        ancestors_a = {id(n): i for i, n in enumerate(pa)}
        # find lowest common ancestor
        for n in pb:
            if id(n) in ancestors_a:
                lca = n
                break
        else:  # pragma: no cover - disconnected trees
            raise ValueError("nodes share no common ancestor")

        def dist_up(node: TreeNode, stop: TreeNode) -> float:
            d = 0.0
            while node is not stop:
                d += node.dist
                node = node.up
            return d

        return dist_up(a, lca) + dist_up(b, lca)

    # -- serialization ------------------------------------------------------
    def write(self) -> str:
        def fmt(node: TreeNode) -> str:
            if node.is_leaf():
                return f"{node.name}:{node.dist:g}"
            inner = ",".join(fmt(c) for c in node.children)
            return f"({inner}){node.name}:{node.dist:g}"

        if self.is_leaf():
            return f"{self.name};"
        inner = ",".join(fmt(c) for c in self.children)
        return f"({inner}){self.name};"

    def __repr__(self) -> str:  # pragma: no cover
        return f"TreeNode({self.name!r}, dist={self.dist}, n_children={len(self.children)})"


class _Tokenizer:
    _PUNCT = set("(),;:")

    def __init__(self, text: str):
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        self._skip_ws()
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def next_punct(self) -> str:
        self._skip_ws()
        ch = self.text[self.pos]
        self.pos += 1
        return ch

    def read_label(self) -> str:
        self._skip_ws()
        if self.pos < len(self.text) and self.text[self.pos] == "'":
            end = self.text.index("'", self.pos + 1)
            label = self.text[self.pos + 1 : end]
            self.pos = end + 1
            return label
        start = self.pos
        while self.pos < len(self.text) and self.text[self.pos] not in self._PUNCT and not self.text[self.pos].isspace():
            self.pos += 1
        return self.text[start : self.pos]

    def _skip_ws(self):
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1


def parse_newick(text: str) -> TreeNode:
    """Parse a Newick string into a ``TreeNode`` tree."""
    tok = _Tokenizer(text.strip())

    def parse_subtree() -> TreeNode:
        node = TreeNode()
        if tok.peek() == "(":
            tok.next_punct()
            node.add_child(parse_subtree())
            while tok.peek() == ",":
                tok.next_punct()
                node.add_child(parse_subtree())
            if tok.next_punct() != ")":
                raise ValueError("malformed newick: expected ')'")
        node.name = tok.read_label()
        if tok.peek() == ":":
            tok.next_punct()
            node.dist = float(tok.read_label())
        return node

    root = parse_subtree()
    if tok.peek() == ";":
        tok.next_punct()
    return root


def load_newick(path: str) -> TreeNode:
    with open(path) as f:
        return parse_newick(f.read())
