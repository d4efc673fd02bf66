"""The port's train step on four gloo ranks (two rows a rank) against the
one-process step: the runs of ``torch_mesh_util.SCENARIOS`` at the bars of
``tests/test_torch_mesh.py``."""

import pytest

import torch_mesh_util as U

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    runs = [make() for make in U.SCENARIOS.values()]
    return U.run_ranks(runs, WORLD, tmp_path_factory.mktemp("mesh4")), U.one_process(runs)


@pytest.mark.parametrize("name", list(U.SCENARIOS))
def test_four_ranks_equal_one_process(ranks, name):
    got, want = ranks
    U.check_run(name, got, want[name])
