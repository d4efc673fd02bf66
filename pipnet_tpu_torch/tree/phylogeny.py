"""Phylogeny wrapper: relative-distance species grouping over a Newick tree.

Counterpart of the reference's ``PhylogenyCUB`` (``util/phylogeny.py:217-340``)
without the ete3/OpenTree dependencies.  Key semantics reproduced exactly:

* unnamed internal nodes get dummy names ``temp_<postorder index>``
  (ref util/phylogeny.py:337-340);
* ``total_distance`` is the *maximum* leaf-to-root distance
  (ref util/phylogeny.py:311-321);
* ``get_parent_by_name`` corrects the target distance by the leaf's own
  root-distance deficit before walking up (ref util/phylogeny.py:258-278);
* ``get_species_groups`` groups the sorted leaf list by the ancestor found at
  a relative distance, preserving first-seen group order
  (ref util/phylogeny.py:285-302).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from .newick import TreeNode, load_newick, parse_newick


class Phylogeny:
    """Newick phylogeny with relative-distance ancestor queries."""

    def __init__(self, file_path: Optional[str] = None, node_ids: Optional[Sequence[str]] = None,
                 newick: Optional[str] = None):
        if newick is not None:
            self.tree = parse_newick(newick)
        else:
            self.tree = load_newick(file_path)
        # name unnamed internal nodes by postorder index
        for i, node in enumerate(self.tree.traverse("postorder")):
            if not node.name:
                node.name = f"temp_{i}"
        self.node_ids: List[str] = (list(node_ids) if node_ids is not None
                                    else sorted(leaf.name for leaf in self.tree.iter_leaves()))
        self._leaf_by_name: Dict[str, TreeNode] = {}
        for leaf in self.tree.iter_leaves():
            self._leaf_by_name[leaf.name] = leaf
        self._root_distance: Dict[str, float] = {
            name: self.tree.get_distance(leaf) for name, leaf in self._leaf_by_name.items()}
        self.total_distance: float = max(self._root_distance.values())
        self._groups_cache: Dict[float, List[List[str]]] = {}

    # -- queries -------------------------------------------------------------
    def get_distance(self, species1: str, species2: str) -> float:
        if species1 == species2:
            return 0.0
        return self.tree.get_distance(species1, species2)

    def get_parent_by_name(self, species: str, relative_distance: float) -> TreeNode:
        node = self._leaf_by_name[species]
        abs_distance = relative_distance * self.total_distance
        # not all leaves sit at equal depth; compensate so relative distances
        # are measured from the deepest leaf level (ref util/phylogeny.py:264)
        abs_distance -= self.total_distance - self._root_distance[species]
        distance = 0.0
        parent = node
        while distance < abs_distance:
            if parent.up is None:
                break
            parent = parent.up
            distance = self.tree.get_distance(parent, node)
        return parent

    def get_species_groups(self, relative_distance: float) -> List[List[str]]:
        if relative_distance not in self._groups_cache:
            groups: Dict[str, List[str]] = {}
            for species in self.node_ids:
                parent = self.get_parent_by_name(species, relative_distance).name
                groups.setdefault(parent, []).append(species)
            self._groups_cache[relative_distance] = list(groups.values())
        return self._groups_cache[relative_distance]

    def get_siblings_by_name(self, species: str, relative_distance: float) -> List[str]:
        for group in self.get_species_groups(relative_distance):
            if species in group:
                return group
        raise KeyError(f"{species} not found in any group at distance {relative_distance}")


# Alias matching the reference's class name for CUB-style path-based trees.
PhylogenyCUB = Phylogeny
