"""The prototype-axis model parallelism of the port (``--model_parallel``,
``runtime/mesh.py``) on the CPU: the column layout of a model rank
(``ops/segment.py::ProtoColumns``) and the train step on a (1, 2) mesh, two
gloo ranks holding the same rows and each half of the head's columns,
against the one-process step on the same global batch, two steps each
(``torch_mesh_util.MODEL_SCENARIOS``: a tree that a model boundary cuts and
one it does not, the feature losses with BYOL, and a head of each variant
family): loss, metrics and the
whole gradients within 1e-5 / 1e-4, the gathered weights and moments after
the steps, every rank alike.  The (2, 2) mesh is
``test_torch_mesh_model_four.py``; the JAX package's ``dp_mp_mesh(2, 2)``
step ``test_torch_mesh_model_jax.py``; the Trainer and the CLI
``test_torch_mesh_model_trainer.py``.
"""

import numpy as np
import pytest

import torch_mesh_util as U
from pipnet_tpu_torch.ops.segment import ProtoColumns

WORLD, N_MODEL = 2, 2
RUNS = ("cut", "no_cut", "align_uniform_byol", "unit_bias", "gumbel", "spatial", "l2")


def _tree(per_child):
    return U.build(U.make_run("layout", cfg=U.model_config(per_child=per_child)))[1]


@pytest.mark.parametrize("per_child,cut", [(10, [6]), (4, [])])
def test_column_layout_of_the_model_ranks(per_child, cut):
    """Each rank's local nodes, the cut nodes and their one owner: a node
    counts on the rank of its first prototype."""
    tree = _tree(per_child)
    P = tree.num_protos_padded
    owners = np.zeros(tree.num_nodes, int)
    seen = []
    for rank in range(N_MODEL):
        mesh = U.fake_mesh(1, N_MODEL, rank=rank)
        lo, hi = mesh.proto_columns(P)
        assert (lo, hi) == (rank * P // N_MODEL, (rank + 1) * P // N_MODEL)
        cols = ProtoColumns(mesh, tree, lo, hi)
        local = tree.proto_node[lo:hi]
        np.testing.assert_array_equal(cols.nodes, np.unique(local[local >= 0]))
        t = cols._tables
        assert t["n_cut"] == len(cut)
        np.testing.assert_array_equal(cols.nodes[t["cut_pos"]],
                                      [n for n in cut if n in cols.nodes])
        owners[cols.nodes[t["owner"]]] += 1
        seen += cols.nodes.tolist()
        # every local slot in one max table, under its own node
        slots = [s for _, c in t["max_tables"] for s in c.reshape(-1).tolist()]
        assert sorted(slots) == np.flatnonzero(local >= 0).tolist()
    assert (owners == 1).all() and set(seen) == set(range(tree.num_nodes))


def test_a_prototype_axis_the_model_axis_does_not_divide_raises():
    with pytest.raises(ValueError, match="does not split evenly over 3 model ranks"):
        U.fake_mesh(1, 3).proto_columns(256)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = [U.MODEL_SCENARIOS[n]() for n in RUNS]
    return (U.run_ranks(runs, WORLD, tmp_path_factory.mktemp("mesh12"), n_model=N_MODEL),
            U.one_process(runs))


@pytest.mark.parametrize("name", RUNS)
def test_two_model_ranks_equal_one_process(ranks, name):
    got, want = ranks
    U.check_run(name, got, want[name])


def test_model_ranks_hold_their_columns(ranks):
    """A model rank's moments of a head leaf are its half of the columns."""
    got, want = ranks
    for n, dim in (("head.add_on_kernel", 1), ("head.cls_weight", 1),
                   ("head.proto_presence", 0)):
        whole = want["cut"]["mu"][n].shape
        assert got[0]["cut"]["local_mu"][n][dim] * N_MODEL == whole[dim], n


@pytest.mark.parametrize("num", [None, 3])
def test_a_model_rank_keeps_its_columns_of_the_presence_sample(num):
    """``presence_keep`` on a model rank's rows of the presence logits draws
    the noise for the whole of P and keeps the rank's columns: the whole
    sample's, bit for bit."""
    import torch
    from pipnet_tpu_torch.models.pipnet import presence_keep
    tree = _tree(10)
    presence = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (tree.num_protos_padded, 2)).astype(np.float32))
    whole = presence_keep(presence, 7, num)
    for rank in range(N_MODEL):
        mesh = U.fake_mesh(1, N_MODEL, rank=rank)
        lo, hi = mesh.proto_columns(tree.num_protos_padded)
        got = presence_keep(presence[lo:hi], 7, num, columns=ProtoColumns(mesh, tree, lo, hi))
        assert torch.equal(got, whole[..., lo:hi])
