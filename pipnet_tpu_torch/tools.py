"""Dataset preparation utilities (the port's copy of the JAX package's
``tools.py``).

Counterparts of the reference's ``rename_folders.py`` / ``rename_tre.py``:
normalize dataset class-directory names and Newick leaf labels into the
``<prefix>_<NNN>_<Species_Name>`` convention that the tree builder's
internal-node naming relies on (``util/phylo_utils.py:68-81`` expects
``name.split('_')[1]`` to be the class id).

    python -m pipnet_tpu_torch.tools rename-folders /data/train --prefix ina
    python -m pipnet_tpu_torch.tools rename-tree tree.tre out.tre --mapping map.json
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys
from typing import Dict, Optional


def normalize_name(name: str, index: int, prefix: str = "ina") -> str:
    """'Parus major' / 'parus_major' -> '<prefix>_<index:03d>_Parus_Major'."""
    clean = re.sub(r"[^A-Za-z0-9]+", "_", name).strip("_")
    clean = "_".join(w.capitalize() for w in clean.split("_"))
    return f"{prefix}_{index + 1:03d}_{clean}"


def rename_folders(root: str, prefix: str = "ina", dry_run: bool = False
                   ) -> Dict[str, str]:
    """Rename class directories under ``root`` to the convention; returns the
    old->new mapping (also written to ``root/rename_mapping.json``)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    mapping = {}
    for i, name in enumerate(classes):
        if re.match(rf"^{re.escape(prefix)}_\d+_", name):
            mapping[name] = name
            continue
        new = normalize_name(name, i, prefix)
        mapping[name] = new
        if not dry_run:
            os.rename(os.path.join(root, name), os.path.join(root, new))
    if not dry_run:
        with open(os.path.join(root, "rename_mapping.json"), "w") as f:
            json.dump(mapping, f, indent=2)
    return mapping


def rename_tree_leaves(tree_path: str, out_path: str,
                       mapping: Optional[Dict[str, str]] = None,
                       prefix: str = "ina") -> Dict[str, str]:
    """Rewrite Newick leaf labels via ``mapping`` (or auto-normalize)."""
    from .tree.newick import load_newick

    tree = load_newick(tree_path)
    leaves = tree.get_leaves()
    if mapping is None:
        names = sorted(l.name for l in leaves)
        mapping = {n: normalize_name(n, i, prefix) for i, n in enumerate(names)}
    for leaf in leaves:
        if leaf.name in mapping:
            leaf.name = mapping[leaf.name]
    with open(out_path, "w") as f:
        f.write(tree.write() + "\n")
    return mapping


def main(argv=None) -> int:
    p = argparse.ArgumentParser("pipnet_tpu_torch dataset tools")
    sub = p.add_subparsers(dest="cmd", required=True)
    rf = sub.add_parser("rename-folders")
    rf.add_argument("root")
    rf.add_argument("--prefix", default="ina")
    rf.add_argument("--dry_run", action="store_true")
    rt = sub.add_parser("rename-tree")
    rt.add_argument("tree")
    rt.add_argument("out")
    rt.add_argument("--mapping", default=None)
    rt.add_argument("--prefix", default="ina")
    args = p.parse_args(argv)
    if args.cmd == "rename-folders":
        mapping = rename_folders(args.root, args.prefix, args.dry_run)
        print(json.dumps(mapping, indent=2))
    else:
        mapping = None
        if args.mapping:
            with open(args.mapping) as f:
                mapping = json.load(f)
        mapping = rename_tree_leaves(args.tree, args.out, mapping, args.prefix)
        print(f"wrote {args.out} ({len(mapping)} leaves)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
