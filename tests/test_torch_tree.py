"""The port's tree compiler (its own numpy copy) against the JAX package's:
``compile_tree`` must give the same arrays field by field."""

import dataclasses

import numpy as np
import pytest

from torch_port_util import (MULTI_NEWICK, budget, compiled_pair,
                             flagship_roots)


def assert_same_tree(tj, tt):
    for fld in dataclasses.fields(tj):
        a, b = getattr(tj, fld.name), getattr(tt, fld.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, fld.name
            np.testing.assert_array_equal(a, b, err_msg=fld.name)
        elif fld.name == "buckets":
            assert [dataclasses.astuple(x) for x in a] == \
                [dataclasses.astuple(x) for x in b]
        else:
            assert a == b, fld.name


@pytest.mark.parametrize("per_child,per_desc,protopool,weighted", [
    (10, 0, False, False), (10, 0, True, True), (0, 4, False, True)])
def test_tiny_tree_matches_jax(tiny_newick, per_child, per_desc, protopool,
                               weighted):
    tj, tt = compiled_pair(tiny_newick, per_child, per_desc, protopool, weighted)
    assert_same_tree(tj, tt)


@pytest.mark.parametrize("per_child,per_desc", [(10, 0), (2, 3)])
def test_multi_bucket_tree_matches_jax(per_child, per_desc):
    tj, tt = compiled_pair(MULTI_NEWICK, per_child, per_desc)
    assert len(tt.buckets) >= 3
    assert_same_tree(tj, tt)


def test_flagship_tree_matches_jax():
    from pipnet_tpu.tree import compile_tree as jax_compile
    from pipnet_tpu_torch.tree import compile_tree as torch_compile
    rj, rt, classes = flagship_roots()
    tj = jax_compile(budget(rj, 10), class_names=classes, protopool=False,
                     weighted=True)
    tt = torch_compile(budget(rt, 10), class_names=classes, protopool=False,
                       weighted=True)
    assert_same_tree(tj, tt)
    assert (tt.num_nodes, tt.num_children_total, tt.num_protos_padded) == (189, 378, 3840)
    assert int(tt.proto_valid.sum()) == 3780
    assert [(b.num_nodes, b.width) for b in tt.buckets] == [(189, 20)]


def test_node_dict_round_trip(tiny_newick):
    from torch_port_util import roots_from_newick
    from pipnet_tpu_torch.tree import Node
    _, rt = roots_from_newick(tiny_newick)
    again = Node.from_dict(rt.to_dict())
    assert again.to_dict() == rt.to_dict()
    assert again.leaf_descendents == rt.leaf_descendents
