"""Shared helpers for the PyTorch port's parity tests.

The same inputs, made from a seed with numpy, go through the JAX package
(the reference) and its counterpart in ``pipnet_tpu_torch``; arrays cross
between the two as numpy.
"""

import contextlib
import functools
import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_META = os.path.join(REPO, "artifacts", "lou_190_s2", "metadata")

# a tree whose internal nodes have 2, 3 and 4 children, so per-child budgets
# give several bucket widths
MULTI_NEWICK = (
    "((cub_001_A:1,cub_002_B:1,cub_003_C:1):1,"
    "((cub_004_D:1,cub_005_E:1):1,cub_006_F:1,cub_007_G:1,cub_008_H:1):1,"
    "(cub_009_I:1,cub_010_J:1):1);"
)

SMALL_DEPTHS = (1, 1, 2, 1)
SMALL_DIMS = (8, 16, 32, 64)
# stride thresholds that give the small widths the 26 / 13 / 7 surgery
SMALL_THRESHOLDS = {"convnext_tiny_26": 10, "convnext_tiny_13": 20,
                    "convnext_tiny_7": None}


def budget(root, per_child=10, per_desc=0):
    for node in root.nodes_with_children():
        node.set_num_protos(num_protos_per_descendant=per_desc,
                            num_protos_per_child=per_child,
                            min_protos=0, split_protos=True)
    return root


def roots_from_newick(newick):
    """(JAX-package root, port root) parsed from the same Newick string."""
    import pipnet_tpu.tree as jt
    import pipnet_tpu_torch.tree as tt
    out = []
    for mod in (jt, tt):
        root = mod.construct_phylo_tree(phylo=mod.Phylogeny(newick=newick))
        root.assign_all_descendents()
        out.append(root)
    return tuple(out)


def flagship_roots():
    """(JAX-package root, port root, classes) of the flagship 190-class tree."""
    import pipnet_tpu.tree as jt
    import pipnet_tpu_torch.tree as tt
    with open(os.path.join(FLAGSHIP_META, "tree.json")) as f:
        d = json.load(f)
    with open(os.path.join(FLAGSHIP_META, "classes.json")) as f:
        classes = json.load(f)
    return jt.Node.from_dict(d), tt.Node.from_dict(d), classes


def compiled_pair(newick, per_child=10, per_desc=0, protopool=False,
                  weighted=False, class_names=None):
    """The same budgeted tree compiled by both packages."""
    from pipnet_tpu.tree import compile_tree as jax_compile
    from pipnet_tpu_torch.tree import compile_tree as torch_compile
    rj, rt = roots_from_newick(newick)
    kw = dict(class_names=class_names, protopool=protopool, weighted=weighted)
    return (jax_compile(budget(rj, per_child, per_desc), **kw),
            torch_compile(budget(rt, per_child, per_desc), **kw))


@contextlib.contextmanager
def small_backbones():
    """Both packages' ``BACKBONES`` tables point at narrow ConvNeXts
    (SMALL_DEPTHS / SMALL_DIMS) with the same stride surgery as the
    full-width names, for the duration of the block."""
    import pipnet_tpu.models.pipnet as jp
    import pipnet_tpu_torch.models.pipnet as tp
    from pipnet_tpu.models.convnext import ConvNeXtTiny as JaxConvNeXt
    from pipnet_tpu_torch.models.convnext import ConvNeXtTiny as TorchConvNeXt
    with pytest.MonkeyPatch.context() as mp:
        for name, thr in SMALL_THRESHOLDS.items():
            for table, ctor in ((jp.BACKBONES, JaxConvNeXt),
                                (tp.BACKBONES, TorchConvNeXt)):
                mp.setitem(table, name, (functools.partial(
                    ctor, stride_threshold=thr, depths=SMALL_DEPTHS,
                    dims=SMALL_DIMS), SMALL_DIMS[-1]))
        yield


def to_jax(tree):
    """Nested dicts of numpy arrays -> nested dicts of jnp arrays."""
    import jax
    import jax.numpy as jnp
    return jax.tree_util.tree_map(jnp.asarray, tree)
