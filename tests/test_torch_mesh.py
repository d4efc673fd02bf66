"""The port's mesh (``pipnet_tpu_torch/runtime/mesh.py``) on the CPU: the
state layouts against the JAX package's ``state_shardings`` rules
(``tests/test_model_parallel.py``), the batch split, and the train step on
two gloo ranks (one process a rank, ``torch_mesh_worker.py``) against the
one-process step on the same global batch, two steps each
(``torch_mesh_util.SCENARIOS``): loss, metrics and gradients within 1e-5 /
1e-4, weights and Adam moments after the steps, every rank alike.  The
four-rank runs are ``test_torch_mesh_four.py``; the JAX package's own mesh
step ``test_torch_mesh_jax.py``.
"""

import numpy as np
import pytest
import torch

import torch_mesh_util as U
from pipnet_tpu_torch.runtime.mesh import (PROTO_AXIS_PARAMS, BatchShard, data_mesh,
                                           dp_mp_mesh, shard_batch, state_shardings)

WORLD = 2


@pytest.fixture(scope="module")
def state():
    from pipnet_tpu_torch.train import init_train_state
    run = U.make_run("specs", backbone=("convnext", 0.0))
    model, _ = U.build(run)
    return init_train_state(model)


def test_head_params_split_on_proto_axis(state):
    sh = state_shardings(U.fake_mesh(4, 2), state)
    assert sh["params"]["head.add_on_kernel"] == (1, "model")
    assert sh["params"]["head.cls_weight"] == (1, "model")
    assert sh["params"]["head.proto_presence"] == (0, "model")
    assert sh["params"]["head.multiplier"] is None
    # the moments mirror their parameters
    assert sh["mu"]["head.add_on_kernel"] == (1, "model")
    assert sh["nu"]["head.cls_weight"] == (1, "model")
    assert all(s is None for n, s in sh["params"].items() if n.startswith("backbone."))
    assert set(PROTO_AXIS_PARAMS) >= {n for n, s in sh["params"].items() if s}


def test_1d_mesh_keeps_everything_whole(state):
    sh = state_shardings(U.fake_mesh(8), state)
    assert all(s is None for part in sh.values() for s in part.values())


def test_zero1_specs(state):
    """ZeRO-1 splits the moments over data (largest divisible dim), not the
    parameters; the bulk of the moments' bytes is split."""
    sh = state_shardings(U.fake_mesh(8), state, zero1=True)
    assert all(s is None for s in sh["params"].values())
    split = sum(state.opt.mu[n].numel() for n, s in sh["mu"].items() if s)
    assert split / sum(t.numel() for t in state.opt.mu.values()) > 0.5
    for n, s in sh["mu"].items():
        t = state.opt.mu[n]
        if s is None:
            assert all(d % 8 for d in t.shape), n
        else:
            dim, axis = s
            assert axis == "data" and t.shape[dim] % 8 == 0
            assert t.shape[dim] == max(d for d in t.shape if d % 8 == 0)
        assert sh["nu"][n] == s


def test_zero1_keeps_the_model_split_of_head_leaves(state):
    sh = state_shardings(U.fake_mesh(4, 2), state, zero1=True)
    assert sh["mu"]["head.cls_weight"] == (1, "model")
    assert sh["mu"]["backbone.stage2_block0.mlp_in.weight"][1] == "data"


def test_meshes_of_one_process():
    assert not torch.distributed.is_initialized()
    mesh = data_mesh(device="cpu")
    assert (mesh.world, mesh.rank, mesh.n_data, mesh.n_model, mesh.data_group) == \
        (1, 0, 1, 1, None)
    with pytest.raises(ValueError, match=r"need 8 devices for a \(4,2\) mesh, found 1"):
        dp_mp_mesh(4, 2, device="cpu")
    with pytest.raises(ValueError, match="process group of 2"):
        data_mesh(2, device="cpu")


def test_rows_of_a_rank():
    """A rank's rows: its contiguous chunk of the batch, and of each view of
    a two-view batch; ``shard_batch`` refuses a batch that does not split."""
    x = np.arange(12)
    mesh = U.fake_mesh(3, rank=1)
    assert shard_batch(mesh, x)[0].tolist() == [4, 5, 6, 7]
    two_views = torch.arange(12)                 # [view 1: 0..5; view 2: 6..11]
    assert BatchShard(mesh).local(two_views).tolist() == [2, 3, 8, 9]
    assert BatchShard(mesh, views=1).local(two_views).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="does not split"):
        shard_batch(mesh, np.arange(10))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = [make() for make in U.SCENARIOS.values()] + [U.backbone64_run()]
    return U.run_ranks(runs, WORLD, tmp_path_factory.mktemp("mesh2")), U.one_process(runs)


@pytest.mark.parametrize("name", list(U.SCENARIOS))
def test_two_ranks_equal_one_process(ranks, name):
    got, want = ranks
    U.check_run(name, got, want[name])


def test_zero1_ranks_hold_their_parts_of_the_moments(ranks):
    got, want = ranks
    local, whole = got[0]["zero1"]["local_mu"], want["zero1"]["mu"]
    split = [n for n in whole if local[n] != whole[n].shape]
    assert len(split) > len(whole) // 2
    for n in split:
        assert np.prod(local[n]) * WORLD == whole[n].size, n


def test_global_batchnorm_in_float64(ranks):
    """ResNet-18's backbone with BatchNorm over the two ranks' rows equals
    the one-process backbone in float64: features, gradients and running
    statistics within 1e-10."""
    got, want = ranks
    y = np.concatenate([r["backbone64"]["y"] for r in got])
    np.testing.assert_allclose(y, want["backbone64"]["y"], rtol=0, atol=1e-10)
    for part in ("grads", "buffers"):
        for n, v in want["backbone64"][part].items():
            for r in got:
                np.testing.assert_allclose(r["backbone64"][part][n], v, rtol=1e-10,
                                           atol=1e-10, err_msg=f"{part} {n}")
